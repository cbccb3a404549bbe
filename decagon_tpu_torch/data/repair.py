"""Artifact-repair utilities for recorded held-out-edge CSVs and npz dumps.

The port's copy of ``decagon_tpu/data/repair.py``, unchanged.

Capability spec: the reference's manual-recovery scripts
``main/Utils/TestEdgeFileRepair.py:16-58`` (re-pair a held-out-edge CSV
whose rows were written with missing/duplicated columns — the reference
version itself writes FromNode twice at ``:55-58``, a bit-rot bug NOT
reproduced) and ``main/Utils/NpzArchiveFixer.py:7-28`` (rewrite an npz
archive whose members were saved under wrong keys).  These exist because
long training runs occasionally leave half-written artifacts; keeping
first-class repair tools beats ad-hoc notebook surgery.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

HEADER = ["FromNode", "ToNode", "RelationId", "Label"]


def repair_heldout_edges_csv(
    in_path: str, out_path: Optional[str] = None
) -> str:
    """Rewrite a held-out-edge CSV, dropping malformed rows.

    Keeps rows that have exactly the 4 expected fields with a valid
    0/1 label, both endpoints non-empty, and (as in the reference's
    repair intent) normalizes accidental whitespace.  Returns the output
    path (defaults to ``<in_path>.repaired``).
    """
    out_path = out_path or in_path + ".repaired"
    kept = 0
    dropped = 0
    with open(in_path, newline="") as fin, open(
        out_path, "w", newline=""
    ) as fout:
        reader = csv.reader(fin)
        writer = csv.writer(fout)
        writer.writerow(HEADER)
        for i, row in enumerate(reader):
            if i == 0 and [c.strip() for c in row[:4]] == HEADER:
                continue
            row = [c.strip() for c in row if c.strip() != ""]
            if len(row) != 4 or row[3] not in ("0", "1"):
                dropped += 1
                continue
            writer.writerow(row)
            kept += 1
    print(f"repair: kept {kept} rows, dropped {dropped} -> {out_path}")
    return out_path


def repair_npz_archive(
    in_path: str,
    key_map: Optional[Dict[str, str]] = None,
    out_path: Optional[str] = None,
) -> str:
    """Rewrite an npz archive with corrected member names.

    ``key_map`` renames members (``{"arr_0": "EmbeddingImportance-..."}``);
    unmapped members keep their names.  Members that fail to deserialize
    are dropped (reported), matching the reference fixer's intent of
    salvaging what loads.
    """
    out_path = out_path or in_path + ".repaired.npz"
    key_map = key_map or {}
    salvaged: Dict[str, np.ndarray] = {}
    dropped: List[str] = []
    with np.load(in_path, allow_pickle=False) as archive:
        for name in archive.files:
            try:
                salvaged[key_map.get(name, name)] = archive[name]
            except Exception:
                dropped.append(name)
    np.savez(out_path, **salvaged)
    if dropped:
        print(f"repair: dropped unreadable members {dropped}")
    print(f"repair: wrote {len(salvaged)} members -> {out_path}")
    return out_path
