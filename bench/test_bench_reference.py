"""The reference against the program's plain CPU path on a tiny store,
and the quantities it works out again against the program's own."""
import numpy as np
import pytest
import torch

from bench import harness, manifest as mf
from bench import reference as ref_mod
from bench.reference import Reference


def _tiny(name="cifar10", n=512):
    cfg = mf.config(name)
    cfg.update(n=n, image_shape=[8, 8, 3])
    return cfg


@pytest.mark.parametrize("name", ["cifar10", "imagenet32"])
def test_sizes_match_the_programs_masked_sizes(name):
    from repro_torch.core import GoldDiffConfig, make_schedule
    from repro_torch.core.engine import masked_sizes
    cfg = mf.config(name)
    sched = make_schedule(cfg["schedule"], cfg["schedule_steps"])
    gd = GoldDiffConfig(**cfg["golddiff"])
    for st in ref_mod.steps_of(cfg):
        g, m, k = masked_sizes(gd, sched, torch.tensor([st.t]), cfg["n"])
        assert (st.m, st.k) == (int(m[0]), int(k[0]))
        assert st.a == float(torch.tensor(sched.a[st.t],
                                          dtype=torch.float32))


def test_row_seed_and_noise_match_the_programs():
    from repro_torch.launch import serve
    assert all(ref_mod.row_seed(s, i) == serve.row_seed(s, i)
               for s in (0, 5, 2 ** 31 + 3) for i in (0, 1, 15))
    cfg = _tiny()
    X = harness.make_rows(cfg, 1, "cpu")
    mix = dict(mf.traffic("b16"), max_batch=4)
    eng = harness.build_program(cfg, mix, X, "cpu")
    req = serve.Request(0, 3, seed=2 ** 31 + 9)
    theirs = eng._noise_rows([(req, 0, 3)], 4)[:3]
    mine = ref_mod.x_T(cfg, [(2 ** 31 + 9, i) for i in range(3)])
    assert torch.equal(mine, theirs)


@pytest.mark.parametrize("name", ["cifar10", "imagenet32"])
def test_reference_matches_the_plain_path(name):
    cfg = _tiny(name, n=2048 if name == "imagenet32" else 512)
    X = harness.make_rows(cfg, 7, "cpu")
    mix = dict(mf.traffic("b16"), images_per_request=[4], max_batch=4)
    eng = harness.build_program(cfg, mix, X, "cpu")
    served = harness.serve_group(eng, [(0, 4, 123), (1, 3, 2 ** 32 - 1)])
    ref = Reference(cfg, harness.make_rows(cfg, 7, "cpu"))
    gaps, _ = harness.check_requests(cfg, ref, served)
    assert len(gaps) == 7 and max(gaps) <= 1e-5
    # the route the configuration's fractions take on the program
    assert eng.engine.use_fused(1000) == (name == "cifar10")
