"""The port's online k-means (`training/kmeans.py`) and LR schedule
(`training/lr_schedule.py`) against the JAX package's, on the same seeded
numpy inputs. Lloyd's iterations start from JAX's own init rows (the rows
`jax.random.choice` draws for the same key) and land within 1e-5; the
bookkeeping and `should_refresh` are exact; `refresh_codebook` from JAX's
init rows writes the same rows within 1e-5 and the same timeouts; the
schedule agrees within 1e-6 relative (both compute in float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgam_neurips22_tpu.training import kmeans as j_kmeans
from sgam_neurips22_tpu.training.lr_schedule import lambda_warmup_cosine as j_schedule
from sgam_neurips22_tpu_torch.training import kmeans as t_kmeans
from sgam_neurips22_tpu_torch.training.lr_schedule import lambda_warmup_cosine as t_schedule


def clustered(seed, m=600, d=16, centres=12):
    """Rows around `centres` well-separated centres: no near-ties between
    assignments, so rounding cannot send a row to another cluster."""
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 4, (centres, d)).astype(np.float32)
    return (c[rng.integers(0, centres, m)] + rng.normal(0, 0.3, (m, d))).astype(np.float32)


def jax_init_rows(key, m, k):
    return np.asarray(jax.random.choice(key, m, (k,), replace=False))


@pytest.mark.parametrize("k", [4, 12, 30])
def test_lloyd_from_jax_init_matches_jax(k):
    data = clustered(k)
    key = jax.random.PRNGKey(k)
    want = np.asarray(j_kmeans.kmeans(key, jnp.asarray(data), k))
    idx = jax_init_rows(key, len(data), k)
    got = t_kmeans.lloyd(torch.from_numpy(data), torch.from_numpy(data[idx])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_kmeans_init_draws_distinct_rows():
    data = torch.arange(40.0).reshape(20, 2)
    rows = t_kmeans.kmeans_init(data, 20, torch.Generator().manual_seed(0))
    assert len({tuple(r) for r in rows.tolist()}) == 20
    with pytest.raises(ValueError, match="exceeds"):
        t_kmeans.kmeans_init(data, 21, torch.Generator().manual_seed(0))


def _states(n_embed=16, size=3, p=4, d=5, timeout=2):
    return (j_kmeans.init_kmeans_state(n_embed, size, p, d, timeout),
            t_kmeans.init_kmeans_state(n_embed, size, p, d, timeout))


def _equal(t_state, j_state):
    np.testing.assert_array_equal(t_state.timeout.numpy(), np.asarray(j_state.timeout))
    np.testing.assert_array_equal(t_state.buffer.numpy(), np.asarray(j_state.buffer))
    assert t_state.ptr == int(j_state.ptr)


def test_bookkeeping_bit_exact():
    """Seven steps (the ring buffer of 3 wraps twice), indices of batch
    element 0 only, timeouts reset then decremented."""
    rng = np.random.default_rng(0)
    j_state, t_state = _states()
    for _ in range(7):
        idx = rng.integers(0, 16, (2, 2)).astype(np.int32)
        feat = rng.normal(size=(2, 2, 5)).astype(np.float32)
        j_state = j_kmeans.kmeans_bookkeeping(j_state, jnp.asarray(idx), jnp.asarray(feat), 2)
        t_kmeans.kmeans_bookkeeping(t_state, torch.from_numpy(idx), torch.from_numpy(feat), 2)
        _equal(t_state, j_state)


def test_should_refresh_matches_jax():
    rng = np.random.default_rng(1)
    j_state, t_state = _states(timeout=1)
    for step in range(8):
        for args in ((0.1, 2, 0), (0.1, 4, 0), (0.9, 2, 0), (0.1, 2, 6), (0.1, 0, 0)):
            assert t_kmeans.should_refresh(t_state, step, *args) == j_kmeans.should_refresh(j_state, step, *args)
        idx = rng.integers(0, 4, (2, 2)).astype(np.int32)
        feat = rng.normal(size=(2, 2, 5)).astype(np.float32)
        j_state = j_kmeans.kmeans_bookkeeping(j_state, jnp.asarray(idx), jnp.asarray(feat), 1)
        t_kmeans.kmeans_bookkeeping(t_state, torch.from_numpy(idx), torch.from_numpy(feat), 1)
    assert t_kmeans.should_refresh(t_state, 8, 0.1, 2)


def test_refresh_codebook_from_jax_init(monkeypatch):
    """The inactive rows are re-clustered from the buffer and get their
    timeout back; the active rows stay. The port's init is replaced by the
    rows JAX's key draws."""
    n_embed, size, p, d = 24, 4, 50, 16
    data = clustered(3, m=size * p, d=d, centres=6)
    codebook = np.random.default_rng(4).normal(size=(n_embed, d)).astype(np.float32)
    timeout = np.where(np.arange(n_embed) % 3 == 0, 5, 0).astype(np.int32)
    j_state = j_kmeans.KMeansState(jnp.asarray(timeout), jnp.asarray(data.reshape(size, p, d)), jnp.asarray(size))
    t_state = t_kmeans.KMeansState(torch.from_numpy(timeout.copy()), torch.from_numpy(data.reshape(size, p, d)), size)
    key = jax.random.PRNGKey(9)
    k = int((timeout <= 0).sum())
    idx = jax_init_rows(key, size * p, k)
    monkeypatch.setattr(t_kmeans, "kmeans_init", lambda feats, kk, gen: feats[torch.tensor(idx)])
    j_cb, j_state = j_kmeans.refresh_codebook(key, jnp.asarray(codebook), j_state, 7)
    t_cb = torch.from_numpy(codebook.copy())
    assert t_kmeans.refresh_codebook(t_cb, t_state, 7, torch.Generator()) == k
    np.testing.assert_allclose(t_cb.numpy(), np.asarray(j_cb), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t_state.timeout.numpy(), np.asarray(j_state.timeout))
    active = timeout > 0
    np.testing.assert_array_equal(t_cb.numpy()[active], codebook[active])


@pytest.mark.parametrize("args", [(10, 0.0, 1.0, 0.0, 100), (3, 0.1, 2.0, 0.5, 20), (0, 0.0, 1.0, 0.0, 5)])
def test_lr_schedule_matches_jax(args):
    j, t = j_schedule(*args), t_schedule(*args)
    for step in [0, 1, 2, 3, 5, 9, 10, 11, 50, 99, 100, 150]:
        np.testing.assert_allclose(float(t(step)), float(j(step)), rtol=1e-6, atol=1e-9, err_msg=str(step))
