"""Launch shapes of ``intersect_count`` on a mining or streaming path, and
the device time of the operand copies around it, under ``torch.profiler``.

Used by ``tools/profile_mine.py`` and ``tools/profile_stream.py``:

    trace = PairCountTrace()
    with trace.hooked():
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
            ...   # a mine or a stream
    report = trace.report(prof)

While hooked, every call of the compiler's ``_kernel_pair_count`` (the one
place the mining path reaches the kernel) records its query shape
``lead = (B_seed, W1, ..., Wk)``, its tile widths and ``ordered``, and
launches a marker kernel (``torch.cuda._sleep(0)``, a ``spin_kernel`` of
no length) before it runs.  On the one stream the device runs kernels in
launch order, so the kernels between a marker and the next
``intersect_count`` kernel are what ``_kernel_pair_count`` launched around
the kernel (the copies and fills of its operands), and the k-th
``intersect_count`` kernel is the k-th call's.  Each call also reads the
caching allocator before and after (host only, no sync): the peak device
memory the call adds beyond its (B,) int32 output is what its copies held.
The window bounds' forms are kept per shape (``window_form``: a_lo,
a_hi, b_lo, b_hi).
"""
from __future__ import annotations

import collections
import contextlib
import math

MARKER = "spin"  # the name of torch.cuda._sleep's kernel contains it
KERNEL = "intersect_count"


def window_form(w, lead) -> str:
    """How a window bound varies: ``s`` a Python int, ``f`` a tensor
    constant along W1...Wk (one value per seed row), ``r`` one that varies
    along them."""
    import torch

    if not isinstance(w, torch.Tensor):
        return "s"
    full = w.expand(tuple(lead) + (1,))
    const = all(n == 1 or st == 0 for n, st in zip(full.shape[1:-1], full.stride()[1:-1]))
    return "f" if const else "r"


class PairCountTrace:
    def __init__(self):
        # (rows, Da, Db, rep, ordered, window forms, peak bytes added beyond the output)
        self.calls = []

    @contextlib.contextmanager
    def hooked(self):
        import torch

        import repro_torch.core.compiler as TC

        orig = TC._kernel_pair_count

        def traced(lead, d_a, d_b, *rest):
            rows = math.prod(lead)
            m0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda._sleep(0)
            out = orig(lead, d_a, d_b, *rest)
            peak = torch.cuda.max_memory_allocated() - m0 - 4 * rows
            forms = "".join(window_form(w, lead) for w in rest[4:8])
            self.calls.append((rows, d_a, d_b, math.prod(lead[1:]), bool(rest[-1]), forms, max(0, peak)))
            return out

        TC._kernel_pair_count = traced
        try:
            yield self
        finally:
            TC._kernel_pair_count = orig

    def report(self, prof) -> dict:
        """The launch-shape histogram (launches and kernel device ms per
        ``(B, Da, Db, W1...Wk, ordered)``), the copies' device ms, kernels and
        bytes per shape, and the peak memory the largest launch's copies add."""
        import torch

        kernels = sorted(
            (ev for ev in prof.events() if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA),
            key=lambda ev: ev.time_range.start,
        )
        per_call = []  # (kernel us, copies us, copy kernels) per call, in launch order
        copies_us, n_copies, open_ = 0.0, 0, False
        for ev in kernels:
            if MARKER in ev.name:
                copies_us, n_copies, open_ = 0.0, 0, True
            elif KERNEL in ev.name:
                per_call.append((ev.device_time_total, copies_us if open_ else None, n_copies if open_ else None))
                open_ = False
            elif open_:
                copies_us += ev.device_time_total
                n_copies += 1
        matched = len(per_call) == len(self.calls)
        hist = collections.defaultdict(lambda: {"launches": 0, "kernel_ms": 0.0, "copies_ms": 0.0,
                                                "copy_kernels": 0, "copy_bytes_peak": 0})
        for i, (rows, da, db, rep, ordered, forms, peak) in enumerate(self.calls):
            h = hist[(rows, da, db, rep, ordered, forms)]
            h["launches"] += 1
            h["copy_bytes_peak"] = max(h["copy_bytes_peak"], peak)
            if matched:
                k_us, c_us, n_c = per_call[i]
                h["kernel_ms"] += k_us / 1e3
                h["copies_ms"] += (c_us or 0.0) / 1e3
                h["copy_kernels"] += n_c or 0
        rows = [{"B": k[0], "Da": k[1], "Db": k[2], "W1_Wk": k[3], "ordered": k[4], "windows": k[5], **v}
                for k, v in hist.items()]
        rows.sort(key=lambda r: -r["B"] * r["Da"] * r["Db"])
        big = rows[0] if rows else None
        return {
            "calls": len(self.calls),
            "kernels_profiled": len(per_call),
            "matched": matched,  # False: the profiler dropped kernels, per-shape times not attributed
            "kernel_ms": sum(r["kernel_ms"] for r in rows) if matched else None,
            "copies_ms": sum(r["copies_ms"] for r in rows) if matched else None,
            "copy_kernels": sum(r["copy_kernels"] for r in rows) if matched else None,
            "largest": big,
            "largest_copy_bytes_peak": big["copy_bytes_peak"] if big else 0,
            "shapes": rows,
        }
