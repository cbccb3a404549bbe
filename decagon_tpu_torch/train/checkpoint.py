"""Checkpointing: params, optimizer state and step, and the npy export.

Port of ``decagon_tpu/train/checkpoint.py`` (reference
``main/Checkpointer/TensorflowCheckpointer.py``: save and restore with
``MaxCheckpointsToKeep``, every-N gating from ``BaseCheckpointer.py:4-24``;
the npy export of ``DecagonLogger._writeAsNdarray``,
``DecagonLogger.py:232-287``).  The JAX package writes orbax
checkpoints; here each step is one ``torch.save`` file, ``<step>.pt``, of
the state with every tensor moved to the CPU.  In a multi-process run only
rank 0 writes, and every rank waits for the file before going on; every
rank restores.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from decagon_tpu_torch.graph.device import DeviceGraph, etkey
from decagon_tpu_torch.graph.renumber import restore_external_rows
from decagon_tpu_torch.parallel.mesh import barrier, process_rank


def _map(fn, tree):
    if isinstance(tree, dict):
        return {key: _map(fn, value) for key, value in tree.items()}
    return fn(tree)


def _to_cpu(x):
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def _like(saved, template, path="state"):
    """``saved`` arranged as ``template``: the same keys, and each tensor
    on the template leaf's device in its dtype.  Raises on a structure
    that does not match."""
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            raise ValueError(f"checkpoint does not match the template at {path}")
        return {key: _like(saved[key], template[key], f"{path}/{key}") for key in template}
    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != template.shape:
            raise ValueError(f"checkpoint does not match the template at {path}")
        return saved.to(device=template.device, dtype=template.dtype)
    return type(template)(saved) if template is not None else saved


def _subtree(saved, template):
    """The part of ``saved`` that ``template`` covers."""
    if isinstance(template, dict):
        return {key: _subtree(saved[key], template[key]) for key in template}
    return saved


class Checkpointer:
    """Every-N gated checkpoints of the training state, the newest
    ``max_to_keep`` kept."""

    def __init__(
        self,
        directory: str,
        max_to_keep: int = 3,
        every_n_iterations: int = 1,
    ):
        self.directory = os.path.abspath(directory)
        Path(self.directory).mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.every_n = max(1, every_n_iterations)
        self.iterations_done = 0

    def increment_iterations(self) -> None:
        self.iterations_done += 1

    @property
    def should_checkpoint(self) -> bool:
        return (self.iterations_done % self.every_n) == 0

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            stem, ext = os.path.splitext(name)
            if ext == ".pt" and stem.isdigit():
                steps.append(int(stem))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def save(self, step: int, state: Dict[str, Any]) -> None:
        """Write ``state`` as ``<step>.pt`` (rank 0 only) and drop the
        oldest beyond ``max_to_keep``; in a multi-process run every rank
        calls it and returns once the file is there."""
        if process_rank() == 0:
            path = self._path(step)
            tmp = f"{path}.tmp{os.getpid()}"
            torch.save(_map(_to_cpu, state), tmp)
            os.replace(tmp, path)
            if self.max_to_keep is not None:
                for old in self.all_steps()[: -self.max_to_keep]:
                    os.remove(self._path(old))
        barrier()

    def restore_latest(
        self,
        template: Optional[Dict[str, Any]] = None,
        partial: bool = False,
    ) -> Optional[Dict[str, Any]]:
        """Restore the newest checkpoint (``None`` if the directory holds
        none), on the CPU, or arranged as ``template`` (its devices and
        dtypes) when given.  With ``partial=True``, ``template`` may cover
        only a subtree of the saved state (e.g. params without optimizer
        state)."""
        step = self.latest_step()
        if step is None:
            return None
        saved = torch.load(self._path(step), map_location="cpu", weights_only=True)
        if template is None:
            return saved
        if partial:
            saved = _subtree(saved, template)
        return _like(saved, template)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def export_ndarrays(
    params: Dict,
    embeddings: Dict[str, torch.Tensor],
    graph: DeviceGraph,
    out_dir: str,
    relation_names: Optional[List[str]] = None,
    drug_type: int = 1,
    node_perms: Optional[Dict[int, np.ndarray]] = None,
) -> None:
    """Write the offline-predictor artifact set, as the JAX package does.

    ``embeddings.npy``: drug-type embeddings [N_drugs, hidden2], in
    external row order when ``node_perms`` (``{type: old_of_new}`` from
    ``graph.renumber.renumber_by_degree``) says training ran renumbered;
    ``EmbeddingImportance.npz`` and one ``EmbeddingImportance-<name>.npy``
    per relation: the per-relation diagonal local factors as dense [d, d]
    matrices; ``GlobalRelations.npy``: the DEDICOM global interaction
    matrix (identity or diagonal stand-ins for the other decoders, as in
    ``decagon/deep/model.py:116-137``).
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    emb = _np(embeddings[str(drug_type)])
    if node_perms is not None and drug_type in node_perms:
        emb = restore_external_rows(emb, node_perms[drug_type])
    np.save(out / "embeddings.npy", emb, allow_pickle=False)

    dd_key = etkey((drug_type, drug_type))
    decoder = dict(graph.decoders)[dd_key]
    dec_params = params["dec"][dd_key]
    num_rel = graph.adj[dd_key].num_rel
    dim = emb.shape[1]

    if decoder == "dedicom":
        glb = _np(dec_params["global"])
        locs = [np.diag(_np(dec_params["local_diag"][k])) for k in range(num_rel)]
    elif decoder == "distmult":
        glb = np.eye(dim, dtype=np.float32)
        locs = [np.diag(np.sqrt(np.abs(_np(dec_params["relation_diag"][k]))))
                for k in range(num_rel)]
    elif decoder == "bilinear":
        # No (diag, glb, diag) factorization exists; export R_0 as the
        # "global" with identity importance.
        glb = _np(dec_params["relation"][0])
        locs = [np.eye(dim, dtype=np.float32) for _ in range(num_rel)]
    else:
        glb = np.eye(dim, dtype=np.float32)
        locs = [np.eye(dim, dtype=np.float32) for _ in range(num_rel)]

    np.save(out / "GlobalRelations.npy", glb, allow_pickle=False)
    np.savez(out / "EmbeddingImportance.npz", *locs)
    names = relation_names or [str(k) for k in range(num_rel)]
    for k, name in enumerate(names[:num_rel]):
        np.save(out / f"EmbeddingImportance-{name}.npy", locs[k], allow_pickle=False)
