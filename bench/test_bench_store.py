"""The procedural store: drawn from the seed, the same seed the same
rows, standardized; its proxy is the program's ``downsample_proxy``."""
import pytest
import torch

from bench.store import pool_proxy, procedural_rows, sq_norms


@pytest.fixture(scope="module")
def rows():
    return procedural_rows(300, 16, 16, 3, 10, 2 ** 31 + 17, "cpu")


def test_same_seed_same_rows(rows):
    again = procedural_rows(300, 16, 16, 3, 10, 2 ** 31 + 17, "cpu")
    assert torch.equal(rows, again)
    other = procedural_rows(300, 16, 16, 3, 10, 2 ** 31 + 18, "cpu")
    assert not torch.equal(rows, other)


def test_standardized(rows):
    assert rows.shape == (300, 16 * 16 * 3) and rows.dtype == torch.float32
    assert abs(float(rows.mean())) < 1e-4
    assert abs(float(rows.std(unbiased=False)) - 1.0) < 1e-4
    assert torch.isfinite(rows).all()


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_proxy_equals_the_programs(rows, factor):
    from repro_torch.core.dataset import downsample_proxy
    mine = pool_proxy(rows, (16, 16, 3), factor)
    theirs = downsample_proxy(rows.reshape(-1, 16, 16, 3), factor)
    assert torch.equal(mine, theirs)


def test_norms(rows):
    assert torch.allclose(sq_norms(rows), (rows.double() ** 2).sum(-1)
                          .float(), rtol=1e-5)
