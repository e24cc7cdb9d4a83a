"""The frozen work counts against hand-worked values at a tiny shape,
and the distinct rows they read against a count by sets."""
import pytest

from bench import harness, workcount
from bench.reference import Reference
from bench.store import procedural_rows


def test_step_work_by_hand():
    # b=2 queries, N=10 rows, dp=3, D=12, m=4, k=2; 6 distinct candidates,
    # 3 distinct golden rows
    w = workcount.step_work(2, 10, 3, 12, 4, 2, 6, 3)
    # proxy rows + norms 160, candidate rows + norms 312, queries 96,
    # distances 32
    assert w["select"] == (600.0, 312.0)
    # golden rows 144, outputs 96
    assert w["aggregate"] == (240.0, 96.0)
    # the golden rows are not read again: only the outputs are added
    assert w["request"] == (696.0, 408.0)


@pytest.mark.parametrize("byts,flops,term", [
    (3.35e12, 1.0, "bytes"), (1.0, 495e12, "operations"),
    (3.35e12, 990e12, "operations")])
def test_bound_takes_the_larger_term(byts, flops, term):
    sec, which = workcount.bound_s(byts, flops)
    assert which == term
    assert sec == pytest.approx(max(byts / 3.35e12, flops / 495e12))


def _cfg(n=256):
    from bench import manifest as mf
    cfg = mf.config("cifar10")
    cfg.update(n=n, image_shape=[8, 8, 3])
    return cfg


def test_distinct_rows_are_the_union_of_the_batch():
    cfg = _cfg()
    X = procedural_rows(cfg["n"], 8, 8, 3, 10, 3, "cpu")
    ref = Reference(cfg, X)

    class Req:                  # a served request: 3 images, seed 11
        rid, images, seed = 0, 3, 11
        out = None

    x, ids = ref.trajectory(harness.x_T(cfg, [(11, i) for i in range(3)]),
                            keep_ids=True)
    Req.out = x.numpy()
    gaps, counts = harness.check_requests(cfg, ref, [Req], keep_ids=True)
    assert gaps == [0.0, 0.0, 0.0]
    for (cand, gold), (uc, ug), st in zip(ids, counts[0], ref.steps):
        assert uc == len(set(cand.reshape(-1).tolist()))
        assert ug == len(set(gold.reshape(-1).tolist()))
        assert st.m <= uc <= 3 * st.m and st.k <= ug <= 3 * st.k
    work = harness.work_of(cfg, ref, [Req], counts)
    assert work["terms"] == ["aggregate:bytes", "request:bytes",
                             "select:bytes"]
    assert 0 < work["aggregate"][0] < work["select"][0] < work["request"][0]
