"""Arithmetic the per-layer readers share. A reader gets `ctx`: the
cell's `config` and `traffic`, the trace `summary` (`lib/trace.py`),
the driver's `layer` counts, and `flops` (`lib/flops.py`); it returns a
number, or None when it finds nothing to read."""


def peak_flops(ctx) -> float:
    f = ctx["flops"]
    return f.PEAK_BF16_FLOPS if ctx["config"]["dtype"] == "bfloat16" \
        else f.PEAK_F32_FLOPS


def mfu(ctx):
    rate = ctx["layer"].get("flops_per_s")
    return None if not rate else 100.0 * rate / peak_flops(ctx)


def idle(ctx):
    s = ctx["summary"]
    return None if s is None or s.window_s <= 0 else 100.0 * s.idle_share


def roofline(ctx, names, nbytes: float, calls_per_batch: int):
    """A kernel's share of its HBM bound per batch: the bound over its
    device time per batch, where its operands leave the L2 (else the
    bound does not bind and None)."""
    from portbench.lib.trace import is_kernel
    f, s = ctx["flops"], ctx["summary"]
    if s is None or nbytes <= f.L2_BYTES:
        return None
    match = is_kernel(names)
    n = s.device_count(match)
    if n == 0 or n % calls_per_batch:
        return None
    per_batch = s.device_time_s(match) / (n // calls_per_batch)
    return 100.0 * f.bound_s(nbytes=nbytes) / per_batch
