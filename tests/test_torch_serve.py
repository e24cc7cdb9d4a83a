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


def test_unported_modes_and_bases_raise():
    store = make_dataset("gmm", n=32, dim=4, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeEngine(store, mode="plan", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeEngine(store, base="pca", device="cpu")


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
