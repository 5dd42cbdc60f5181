"""What the per-layer readers read from the program's span totals
(`cgs_tpu_torch/utils/profiling.py`: `span_ns` and `span_calls`), which
it keeps only while a profiler records: in a `--trace 1` run, the calls
traced. A program without them, or one that recorded no
`cgs.pipeline.run`, gives None, never an error."""
from cgs_tpu_torch.utils import profiling

RUN = "cgs.pipeline.run"


def span_ms(plus, minus=(), per: str = RUN):
    """The nanoseconds of the spans named in `plus`, less those named in
    `minus`, per exit of span `per`, in ms; None where the program keeps
    no span totals or has recorded no `cgs.pipeline.run` or no `per`."""
    ns = getattr(profiling, "span_ns", None)
    calls = getattr(profiling, "span_calls", None)
    if ns is None or calls is None or not calls.get(RUN) \
            or not calls.get(per):
        return None
    total = sum(ns.get(k, 0) for k in plus) \
        - sum(ns.get(k, 0) for k in minus)
    return total / calls[per] / 1e6
