"""Multi-card scaling model for the sharded train step, on H100 links.

    python -m decagon_tpu_torch.scripts.scaling_model [--out PATH]

Port of ``scripts/scaling_model.py``: per-device, per-step communication
volumes computed exactly from the paper-scale graph and model shapes for a
range of (row, edge) meshes, for the replicated-parameter design and the
default weight-sharded one (``ring_allreduce_bytes``, ``ring_allgather_bytes``,
``step_comm``: the JAX script's formulas), combined with a measured
single-card step time and the links' public bandwidths into a projected
scaling efficiency (``project``, the same formulas):

    T(n) = max(T_compute(n), T_comm(n)),  T_compute(n) = T1 / n,
    efficiency(n) = T1 / (n * T(n)).

Only the inputs differ from the JAX script's:

* the links: the ``edge`` axis stays within a host on NVLink 4, the ``row``
  axis crosses hosts on the inter-node fabric (``EDGE_GBPS``, ``ROW_GBPS``);
* ``T1`` and the parameter bytes: the port's own one-card step with fused
  Adam (K7) on the bf16 dense stacks, the dispatch the sharded step uses,
  and its parameter tree (``artifacts/perf/torch_adam_probe.json``:
  ``step_adam_fused_ms``, ``param_mib``);
* the measured activation-exchange overlap: ``derived.overlap_factor`` of
  ``artifacts/perf/torch_multihost_overlap.json`` (``multihost_overlap.py``)
  where that record exists, gives one, and was measured where the exchange
  can run asynchronously, an NCCL world across cards (``config.backend``
  "nccl", ``config.cards`` > 1); otherwise the measured-overlap variant is
  ``null`` and ``assumptions`` says why.  A world of gloo ranks on one card
  stages every collective through the host: it has no asynchronous
  exchange to hide, so its factor reads host noise, not ``comm_overlap``.

A missing step record is an error.  Writes
``artifacts/perf/torch_scaling_model.json`` (``--out``).  Arithmetic only:
no device.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ART = os.path.join(ROOT, "artifacts", "perf")
OUT = os.path.join(ART, "torch_scaling_model.json")
ADAM_PROBE = os.path.join(ART, "torch_adam_probe.json")
OVERLAP = os.path.join(ART, "torch_multihost_overlap.json")

# Paper-scale workload shapes (bench.py / quality_full.py config).
N_PROT, N_DRUG = 19081, 645
H1, H2 = 64, 32
K_DD = 1926  # 963 side effects x 2 directions
DEC_BYTES = 2**20  # decoder leaves (global + local factors), < 1 MiB
F32 = 4

# NVLink 4 on an H100 SXM5: 18 links, 900 GB/s a card in both directions
# together, 450 GB/s each way (NVIDIA H100 Tensor Core GPU datasheet; the
# edge axis's ring stays within a host behind its NVSwitches).
EDGE_GBPS = 450.0
# The inter-node fabric of a DGX H100: one ConnectX-7 NDR InfiniBand port
# of 400 Gb/s a card, 50 GB/s each way (NVIDIA DGX H100 datasheet); the row
# axis crosses hosts on it.
ROW_GBPS = 50.0

MESHES = [(1, 4), (2, 4), (1, 8), (2, 8), (4, 8)]


def measured_inputs(adam_probe: str = ADAM_PROBE, overlap: str = OVERLAP) -> Dict:
    """T1 (ms), the parameter bytes and the activation overlap factor from
    the port's records, with their sources; the overlap is None (and
    ``overlap_reason`` says why) without an overlap record from an NCCL
    world across cards."""
    if not os.path.exists(adam_probe):
        raise FileNotFoundError(
            f"{adam_probe}: the one-card step record is missing; run "
            f"`python -m decagon_tpu_torch.scripts.probe_adam` on the card first")
    with open(adam_probe) as f:
        probe = json.load(f)
    out = {
        "t1_ms": float(probe["step_adam_fused_ms"]),
        "param_bytes": int(round(float(probe["param_mib"]) * 2**20)),
        "t1_source": f"artifacts/perf/{os.path.basename(adam_probe)} step_adam_fused_ms "
                     f"({probe['device']}, torch {probe['torch']}; K7 launches a step "
                     f"{probe['launches_per_call']['step_adam_fused']})",
        "param_source": f"artifacts/perf/{os.path.basename(adam_probe)} param_mib "
                        f"{probe['param_mib']}",
        "device": probe["device"],
        "torch": probe["torch"],
        "launches_per_step": probe["launches_per_call"]["step_adam_fused"],
        "act_overlap": None,
        "overlap_reason": None,
    }
    if not os.path.exists(overlap):
        out["overlap_reason"] = (f"artifacts/perf/{os.path.basename(overlap)} does not exist: "
                                 "no measured overlap, so no measured-overlap variant")
        return out
    with open(overlap) as f:
        rec = json.load(f)
    name = f"artifacts/perf/{os.path.basename(overlap)}"
    factor = rec.get("derived", {}).get("overlap_factor")
    config = rec.get("config", {})
    if factor is None:
        out["overlap_reason"] = (f"{name} gives no overlap_factor (overlap_off was not slower "
                                 "than the single process): no measured-overlap variant")
    elif config.get("backend") != "nccl" or not config.get("cards", 0) > 1:
        where = (f"backend {config.get('backend', 'not named')}, cards "
                 f"{config.get('cards', 'not named')}; {config.get('pinning')}")
        why = ("an NCCL world on one card holds one rank, with nothing to exchange"
               if config.get("backend") == "nccl" else
               "gloo-staged on one card, every collective passes synchronously through the "
               "host, so there is no asynchronous exchange for comm_overlap to hide, and the "
               "A/B's sign differed between two machines (PERF.md section 6)")
        out["overlap_reason"] = (
            f"{name} holds overlap_factor {factor} from a world that is not NCCL across cards "
            f"({where}): {why}. A factor is applied only from an NCCL world across cards: no "
            "measured-overlap variant")
    else:
        out["act_overlap"] = float(factor)
        out["overlap_source"] = f"{name} derived.overlap_factor ({rec.get('device')})"
    return out


def ring_allreduce_bytes(size_bytes: int, n: int) -> float:
    """Per-device bytes sent for a ring all-reduce of `size_bytes`."""
    if n <= 1:
        return 0.0
    return 2.0 * size_bytes * (n - 1) / n


def ring_allgather_bytes(shard_bytes: int, n: int) -> float:
    """Per-device bytes sent to all-gather `shard_bytes` per device."""
    if n <= 1:
        return 0.0
    return shard_bytes * (n - 1)


def _act_split(nr: int, ne: int) -> Tuple[float, float]:
    """(edge-axis, row-axis) activation bytes of a step: each encoder layer's
    per-node-type row block summed over ``edge`` and gathered over ``row``,
    forward and mirrored backward."""
    act_edge = act_row = 0.0
    for h in (H1, H2):
        for n_nodes in (N_PROT, N_DRUG):
            nb = -(-n_nodes // nr)
            blk = nb * h * F32
            act_edge += 2 * ring_allreduce_bytes(blk, ne)
            act_row += 2 * ring_allgather_bytes(blk, nr)
    return act_edge, act_row


def step_comm(nr: int, ne: int, shard_weights: bool, grad_bytes_per_el: int = F32,
              param_bytes: Optional[int] = None) -> dict:
    """Per-device bytes sent per optimization step, by channel (the JAX
    script's ``step_comm``; ``param_bytes`` defaults to the measured tree).

    Activation exchange, per encoder layer (2 layers, fwd; the backward
    re-runs the mirrored collectives, x2): the ring all-reduce of the
    ``[Nb, H]`` row-block partial over the edge axis for each of the 2
    node-type tables, and the all-gather of row blocks over the row axis.
    Gradients: the replicated design all-reduces every leaf over the mesh;
    the weight-sharded one the encoder's relation blocks over ``row`` and
    the decoder over the mesh."""
    if param_bytes is None:
        param_bytes = measured_inputs()["param_bytes"]
    act = 0.0
    for h in (H1, H2):
        for n_nodes in (N_PROT, N_DRUG):
            blk = -(-n_nodes // nr) * h * F32
            act += ring_allreduce_bytes(blk, ne)  # edge-axis sum
            act += ring_allgather_bytes(blk, nr)  # row-axis gather
    act *= 2  # forward and the mirrored backward
    if shard_weights:
        enc_bytes = (param_bytes - DEC_BYTES) * grad_bytes_per_el // F32
        grad_row = ring_allreduce_bytes(enc_bytes // ne, nr)
        grad_both = ring_allreduce_bytes(DEC_BYTES, nr * ne)
    else:
        grad_row = 0.0
        grad_both = ring_allreduce_bytes(param_bytes, nr * ne)
    return {
        "activations_mib": act / 2**20,
        "grad_row_axis_mib": grad_row / 2**20,
        "grad_mesh_mib": grad_both / 2**20,
        "total_mib": (act + grad_row + grad_both) / 2**20,
    }


def project(nr: int, ne: int, shard_weights: bool, row_is_dcn: bool,
            grad_bytes_per_el: int = F32, t1_ms: Optional[float] = None,
            param_bytes: Optional[int] = None, act_overlap: Optional[float] = None,
            edge_gbps: float = EDGE_GBPS, row_gbps: float = ROW_GBPS) -> dict:
    """The JAX script's ``project``: serial, grad-overlap and measured-overlap
    step times and efficiencies.  ``row_is_dcn``: the row axis rides the
    inter-node fabric (``row_gbps``), else the edge axis's links.  Without
    ``act_overlap`` the measured-overlap fields are None."""
    if t1_ms is None or param_bytes is None:
        inputs = measured_inputs()
        t1_ms = inputs["t1_ms"] if t1_ms is None else t1_ms
        param_bytes = inputs["param_bytes"] if param_bytes is None else param_bytes
    comm = step_comm(nr, ne, shard_weights, grad_bytes_per_el, param_bytes)
    n = nr * ne
    t_compute = t1_ms / n
    row_bw = row_gbps if row_is_dcn else edge_gbps
    act_edge, act_row = _act_split(nr, ne)
    t_comm = (
        act_edge / (edge_gbps * 1e9)
        + act_row / (row_bw * 1e9)
        + comm["grad_row_axis_mib"] * 2**20 / (row_bw * 1e9)
        + comm["grad_mesh_mib"] * 2**20 / (edge_gbps * 1e9)
    ) * 1e3  # ms
    # Serial model (no overlap at all): compute then communicate.
    t_serial = t_compute + t_comm
    # Grad-overlap model: the gradient reduction of step i hides behind
    # step i+1's forward; the activation exchange stays on the critical path.
    act_ms = (act_edge / (edge_gbps * 1e9) + act_row / (row_bw * 1e9)) * 1e3
    grad_ms = t_comm - act_ms
    t_overlap = max(t_compute, grad_ms) + act_ms
    # The measured activation-exchange overlap on top of the grad overlap.
    t_measured = (None if act_overlap is None
                  else max(t_compute, grad_ms) + act_ms * (1.0 - act_overlap))
    return {
        **{k: round(v, 3) for k, v in comm.items()},
        "t_compute_ms": round(t_compute, 3),
        "t_comm_ms": round(t_comm, 3),
        "t_step_serial_ms": round(t_serial, 3),
        "t_step_grad_overlap_ms": round(t_overlap, 3),
        "t_step_measured_overlap_ms": None if t_measured is None else round(t_measured, 3),
        "efficiency_serial": round(t1_ms / (n * t_serial), 3),
        "efficiency_grad_overlap": round(t1_ms / (n * t_overlap), 3),
        "efficiency_measured_overlap": (None if t_measured is None
                                        else round(t1_ms / (n * t_measured), 3)),
    }


def scaling_model(meshes=MESHES, adam_probe: str = ADAM_PROBE, overlap: str = OVERLAP) -> Dict:
    """The record: ``assumptions`` and a projection for each mesh, each
    design and f32 / bf16 gradient reductions."""
    inputs = measured_inputs(adam_probe, overlap)
    kw = dict(t1_ms=inputs["t1_ms"], param_bytes=inputs["param_bytes"],
              act_overlap=inputs["act_overlap"])
    overlap_text = (f"the MEASURED {inputs['act_overlap']} activation-exchange overlap factor "
                    f"from {inputs.get('overlap_source')}" if inputs["act_overlap"] is not None
                    else f"null: {inputs['overlap_reason']}")
    out = {
        # The card and the kernels of the step T1 was measured on.
        "device": inputs["device"],
        "torch": inputs["torch"],
        "t1_launches_per_step": inputs["launches_per_step"],
        "assumptions": {
            "t1_ms": inputs["t1_ms"],
            "ici_gbps_per_dir": EDGE_GBPS,
            "dcn_gbps": ROW_GBPS,
            "links": ("the port's record keeps the JAX script's keys: ici_gbps_per_dir holds the "
                      "edge axis's link, NVLink 4 on an H100 SXM5 (900 GB/s a card both ways, "
                      "450 each way, NVIDIA H100 datasheet); dcn_gbps holds the row axis's, one "
                      "400 Gb/s NDR InfiniBand port a card (50 GB/s each way, NVIDIA DGX H100 "
                      "datasheet)"),
            "param_bytes": inputs["param_bytes"],
            "t1_source": inputs["t1_source"],
            "param_source": inputs["param_source"],
            "measured_act_overlap": inputs["act_overlap"],
            "measured_act_overlap_reason": inputs["overlap_reason"],
            "model": "T(n)=max(T1/n, sum(bytes/bw)); serial / grad-overlap / measured-overlap "
                     f"variants (the last applies {overlap_text}); ring collectives",
            "workload": "963-relation polypharmacy scale, H=64/32, bf16 dense stacks, fused "
                        "Adam (K7, one launch a step: the sharded step's dispatch; the paired "
                        "kernels are single-card only, so T1 is the dense-stack step, not the "
                        "paired headline)",
        },
        "meshes": {},
    }
    for nr, ne in meshes:
        out["meshes"][f"{nr}x{ne}"] = {
            "replicated": project(nr, ne, False, row_is_dcn=nr > 1, **kw),
            "weight_sharded": project(nr, ne, True, row_is_dcn=nr > 1, **kw),
            "weight_sharded_bf16_reduce": project(nr, ne, True, row_is_dcn=nr > 1,
                                                  grad_bytes_per_el=2, **kw),
        }
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--adam-probe", default=ADAM_PROBE)
    ap.add_argument("--overlap", default=OVERLAP)
    args = ap.parse_args(argv)
    out = scaling_model(adam_probe=args.adam_probe, overlap=args.overlap)
    from decagon_tpu_torch.scripts.records import write_json

    write_json(args.out, out)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
