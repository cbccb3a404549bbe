"""Dataset construction: public polypharmacy CSVs and recorded-edge IO."""

from decagon_tpu_torch.data.public import (  # noqa: F401
    load_public_dataset,
    load_public_graph,
)
from decagon_tpu_torch.data.record import write_heldout_edges_csv  # noqa: F401
