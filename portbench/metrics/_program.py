"""What the per-layer readers read from the program itself: the gaps
named after its own spans and its counters (`cgs_tpu_torch/utils/
profiling.py`). A program without them gives None, never an error."""
from cgs_tpu_torch.utils import profiling


def span_gap_s(summary, prefix: str):
    """The idle seconds of the trace's gaps named after a span whose
    name starts with `prefix`; None where the program has no spans."""
    if summary is None or not hasattr(profiling, "span"):
        return None
    return sum(s for s, name in summary.gaps if name.startswith(prefix))


def counters():
    """The program's counters, or None where it keeps none."""
    return getattr(profiling, "counts", None)
