"""Frozen work counts of a GoldDiff request, and the bound they set.

One count per stage, whatever kernels implement it, so that a route or
a kernel that a later change brings reads against the same work.  Each
input byte is counted once and each output byte once (fp32 rows, fp32
norms and distances); the distinct rows come from the reference's own
selections, since the row-union kernels read each distinct row of a
batch once.

* select (query -> golden set): the N proxy rows and their norms, the
  distinct store rows among the batch's top-m_t candidate sets and
  their norms, the queries, and the B m_t distances written;
  2 B (N dp + m_t D) operations;
* aggregate (golden set -> posterior mean): the distinct golden rows
  among the batch's top-k_t sets and the outputs; 2 B k_t D operations;
* the whole request: both, summed over its steps, the golden rows not
  counted again (they are candidates the select stage read).

The bound of a count is the larger of its bytes at the HBM rate and its
operations at the TF32 dense rate, at which the distance products issue
(NVIDIA H100 SXM data sheet, dense, at the 700 W limit).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12
F32 = 4


def select_work(b: int, n: int, dp: int, d: int, m: int,
                distinct: int) -> tuple[float, float]:
    """(bytes, operations) of one select stage over a batch of ``b``
    queries whose candidate sets hold ``distinct`` rows between them."""
    byts = (n * (dp + 1) * F32 + distinct * (d + 1) * F32 + b * d * F32
            + b * m * F32)
    return float(byts), 2.0 * b * (n * dp + m * d)


def aggregate_work(b: int, d: int, k: int,
                   distinct: int) -> tuple[float, float]:
    """(bytes, operations) of one aggregate stage over ``b`` queries
    whose golden sets hold ``distinct`` rows between them."""
    return float(distinct * d * F32 + b * d * F32), 2.0 * b * k * d


def step_work(b: int, n: int, dp: int, d: int, m: int, k: int,
              cand_distinct: int, gold_distinct: int) -> dict:
    """The three counts of one step: ``select``, ``aggregate`` and
    ``request`` (select + aggregate, its golden rows not read again)."""
    sel = select_work(b, n, dp, d, m, cand_distinct)
    agg = aggregate_work(b, d, k, gold_distinct)
    req = (sel[0] + b * d * F32, sel[1] + agg[1])
    return {"select": sel, "aggregate": agg, "request": req}


def bound_s(byts: float, flops: float) -> tuple[float, str]:
    """(seconds, the term that bounds them: "bytes" or "operations")."""
    tb, tf = byts / HBM_BYTES_PER_S, flops / TF32_FLOPS_PER_S
    return (tb, "bytes") if tb >= tf else (tf, "operations")
