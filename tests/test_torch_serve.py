"""The port's ServeEngine on device="cpu", its guards, and the import
boundary between the two packages."""
import ast
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.launch.serve import (Request, ServeEngine,  # noqa: E402
                                      main, row_seed)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def engine():
    store = make_dataset("cifar_like", n=256, seed=0, device="cpu")
    return ServeEngine(store, num_steps=4, max_batch=4, device="cpu")


def test_buckets_and_shapes(engine):
    assert engine.batch_buckets() == [1, 2, 4]
    assert [engine._bucket_for(n) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]
    out = engine.serve([Request(0, 3, seed=5)])
    assert out[0].request_id == 0
    assert out[0].images.shape == (3, 32, 32, 3)
    assert out[0].images.dtype == np.float32
    assert np.isfinite(out[0].images).all()
    assert out[0].latency_s > 0


def test_oversized_request_is_chunked(engine):
    """A 6-image request on max_batch=4 runs over two waves and equals
    its rows served as separate requests: noise depends on (seed, row)."""
    big = engine.serve([Request(1, 6, seed=9)])[0].images
    assert big.shape == (6, 32, 32, 3) and np.isfinite(big).all()
    # rows 4..5 are row 0..1 of a request whose stream starts at row 4
    x = engine._init_noise([(Request(1, 6, seed=9), 4, 2)], 2)
    alone = engine._sample_bucket(x)
    np.testing.assert_array_equal(big[4:], alone)


def test_alone_equals_cobatched_bitwise(engine):
    alone = engine.serve([Request(0, 2, seed=3)])[0].images
    mixed = engine.serve([Request(7, 1, seed=11), Request(0, 2, seed=3),
                          Request(8, 1, seed=12)])
    assert [r.images.shape[0] for r in mixed] == [1, 2, 1]
    np.testing.assert_array_equal(mixed[1].images, alone)


def test_zero_image_request(engine):
    out = engine.serve([Request(0, 0, seed=1), Request(1, 1, seed=2)])
    assert out[0].images.shape == (0, 32, 32, 3)
    assert out[1].images.shape == (1, 32, 32, 3)


def test_row_seed_depends_on_seed_and_row_only():
    assert row_seed(3, 0) == row_seed(3, 0)
    assert len({row_seed(s, r) for s in range(4) for r in range(4)}) == 16


def test_cli_on_cpu(capsys):
    main(["--n", "64", "--requests", "2", "--batch", "2", "--steps", "3",
          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 4 images" in out and "finite=True" in out


@pytest.mark.parametrize("base", ["pca", "kamb"])
def test_cli_patch_base_on_cpu(capsys, base):
    main(["--n", "64", "--requests", "2", "--batch", "2", "--steps", "3",
          "--device", "cpu", "--base", base])
    out = capsys.readouterr().out
    assert f"base {base}, mode static" in out
    assert "served 4 images" in out and "finite=True" in out


def test_unported_modes_and_bases_raise():
    """An unknown mode raises; a patch base serves static mode ("auto"),
    and asking it for the masked body (plan, scan) raises the
    reference's ``ValueError`` (``src/repro/launch/serve.py:158-161``)."""
    store = make_dataset("gmm", n=32, dim=4, device="cpu")
    with pytest.raises(ValueError, match="bogus"):
        ServeEngine(store, mode="bogus", device="cpu")
    img = make_dataset("cifar_like", n=64, seed=0, device="cpu")
    pca = ServeEngine(img, base="pca", num_steps=3, max_batch=2,
                      device="cpu")
    assert pca.mode == "static" and pca.plan is None
    assert pca.denoiser.base.weighting == "ss"
    for mode in ("plan", "scan"):
        with pytest.raises(ValueError, match="static"):
            ServeEngine(img, base="pca", mode=mode, device="cpu")
    stats = pca.warmup()
    base = pca.denoiser.base
    patches = {base.patch_size(int(t)) for t in (1000, 667, 333)}
    assert set(base._features) == patches
    assert stats["feature_cache_bytes"] == len(patches) * 64 * 32 * 32 * 8 * 4
    out = pca.serve([Request(0, 3, seed=4)])[0].images
    assert out.shape == (3, 32, 32, 3) and np.isfinite(out).all()
    assert set(base._features) == patches


# -- plan mode (the reference's tests/test_serve_plan.py:35-131) -----------------

@pytest.fixture(scope="module")
def gmm_engine():
    return ServeEngine("gmm", {"n": 1024, "dim": 16}, num_steps=6,
                       max_batch=8, device="cpu")


def test_plan_mode_is_the_default(gmm_engine):
    assert gmm_engine.mode == "plan"
    assert gmm_engine.plan is not None and gmm_engine.plan.num_steps == 6
    assert gmm_engine.batch_buckets() == [1, 2, 4, 8]
    assert [gmm_engine._bucket_for(n) for n in (1, 3, 8, 100)] == [1, 4, 8, 8]
    odd = ServeEngine("gmm", {"n": 256, "dim": 8}, num_steps=3, max_batch=6,
                      device="cpu")
    assert odd.batch_buckets() == [1, 2, 4, 6]


def test_plan_serve_seed_determinism(gmm_engine):
    """Same request alone and co-batched (another wave and batch bucket)
    -> the same images; other seeds differ."""
    alone = gmm_engine.serve([Request(0, 2, seed=7)])[0].images
    res = gmm_engine.serve([Request(0, 2, seed=7), Request(1, 3, seed=9)])
    np.testing.assert_allclose(res[0].images, alone, rtol=0, atol=1e-6)
    res2 = gmm_engine.serve([Request(1, 3, seed=9), Request(0, 2, seed=7)])
    np.testing.assert_allclose(res2[1].images, alone, rtol=0, atol=1e-6)
    np.testing.assert_allclose(res2[0].images, res[1].images, rtol=0,
                               atol=1e-6)
    other = gmm_engine.serve([Request(0, 2, seed=8)])[0].images
    assert not np.allclose(alone, other)


def test_plan_serve_oversized_request(gmm_engine):
    res = gmm_engine.serve([Request(0, 19, seed=5)])       # max_batch = 8
    assert res[0].images.shape[0] == 19 and np.isfinite(res[0].images).all()
    wide = ServeEngine("gmm", {"n": 1024, "dim": 16}, num_steps=6,
                       max_batch=32, device="cpu")
    np.testing.assert_allclose(res[0].images,
                               wide.serve([Request(0, 19, seed=5)])[0].images,
                               rtol=0, atol=1e-6)
    res0 = gmm_engine.serve([Request(1, 0, seed=1), Request(2, 2, seed=2)])
    assert [r.images.shape[0] for r in res0] == [0, 2]


@pytest.mark.parametrize("mode", ["plan", "scan"])
def test_warmup_then_nothing_built(mode):
    eng = ServeEngine("gmm", {"n": 512, "dim": 16}, num_steps=5,
                      max_batch=4, mode=mode, device="cpu")
    stats = eng.warmup()
    n_batch = len(eng.batch_buckets())
    buckets = eng.plan.num_buckets if mode == "plan" else 1
    assert stats["programs_compiled"] == n_batch * buckets
    assert stats["shape_buckets"] == buckets
    assert stats["batch_buckets"] == [1, 2, 4] and stats["warmup_s"] >= 0
    n0 = eng.engine._builds
    eng.serve([Request(0, 1, seed=1), Request(1, 3, seed=2),
               Request(2, 2, seed=3), Request(3, 4, seed=4)])
    assert eng.engine._builds == n0, "serving built a program after warmup"


def test_serve_modes_agree():
    """plan == scan == static on identical requests."""
    reqs = [Request(0, 2, seed=3), Request(1, 2, seed=4)]
    outs = {}
    for mode in ("plan", "scan", "static"):
        e = ServeEngine("gmm", {"n": 512, "dim": 16}, num_steps=5,
                        max_batch=4, mode=mode, device="cpu")
        assert e.mode == mode and (e.plan is not None) == (mode == "plan")
        outs[mode] = np.concatenate([r.images.reshape(r.images.shape[0], -1)
                                     for r in e.serve(list(reqs))])
    np.testing.assert_allclose(outs["plan"], outs["static"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(outs["plan"], outs["scan"], rtol=1e-4,
                               atol=1e-5)


def test_serve_mode_validation():
    store = make_dataset("gmm", n=64, dim=8, device="cpu")
    with pytest.raises(ValueError, match="unknown serve mode"):
        ServeEngine(store, mode="masked", device="cpu")
    e = ServeEngine(store, num_steps=3, mode="static", device="cpu")
    assert e.mode == "static" and e.plan is None
    assert e.warmup()["programs_compiled"] == 0


def test_cli_plan_flags(capsys):
    main(["--n", "64", "--requests", "1", "--batch", "2", "--steps", "4",
          "--device", "cpu", "--buckets", "1"])
    out = capsys.readouterr().out
    assert "mode plan" in out and "-> 1 buckets" in out
    assert "warmup: 2 programs" in out and "finite=True" in out
    main(["--n", "64", "--requests", "1", "--batch", "2", "--steps", "4",
          "--device", "cpu", "--no-plan", "--no-warmup"])
    out = capsys.readouterr().out
    assert "mode scan" in out and "warmup" not in out


def test_entry_points_need_a_card_or_cpu(monkeypatch):
    """With no card and no device="cpu" the entry points raise: there is
    no silent CPU path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_dataset("cifar_like", n=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine("gmm", {"n": 16, "dim": 4})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_dataset("gmm", n=8, dim=4, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--n", "16"])


def _imports(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_port_imports_nothing_of_jax():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, name)
