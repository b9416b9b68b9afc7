"""The port's row normalization (ops/normalize.py) and table build
(recommend/tables.py) against the JAX package's, on the same inputs.

The JAX side runs as tests/test_ops.py runs it: the Pallas kernel in
interpret mode on the CPU. The port runs its plain version (CPU tensors).
Tolerance: 1e-6 relative (both compute x * rsqrt(max(sum(x^2), eps)) in f32;
the sums may be taken in another order), zero rows exactly zero; the table
build 1e-6 absolute against JAX normalized_tables, one bf16 ulp for bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anime_recommendations_tpu.models import two_tower as jtt
from anime_recommendations_tpu.ops.normalize import l2_normalize_rows as jl2_normalize_rows
from anime_recommendations_tpu_torch.models import two_tower as tt
from anime_recommendations_tpu_torch.ops import l2_normalize_rows
from anime_recommendations_tpu_torch.ops import normalize
from anime_recommendations_tpu_torch.recommend import tables

from test_torch_model import jax_params, numpy_params

torch.set_num_threads(2)


def rows_with_zeros(n, d, seed):
    """Rows of mixed scale, with zero rows at the start, the middle and the end."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32) * rng.uniform(1e-3, 10, (n, 1)).astype(np.float32)
    x[[0, n // 2, n - 1]] = 0.0
    return x


@pytest.mark.parametrize("eps", [1e-24, 1e-12], ids=["eps1e-24", "eps1e-12"])
@pytest.mark.parametrize("shape", [(1037, 48), (3000, 128)], ids=["1037x48", "3000x128"])
def test_l2_normalize_rows_matches_jax(shape, eps):
    x = rows_with_zeros(*shape, seed=shape[0])
    got = l2_normalize_rows(torch.from_numpy(x), eps=eps)
    want = np.asarray(jl2_normalize_rows(jnp.asarray(x), eps=eps))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    zero = ~x.any(axis=1)
    assert zero.sum() == 3 and (got.numpy()[zero] == 0).all()
    norms = np.linalg.norm(got.numpy()[~zero].astype(np.float64), axis=1)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-6)


def test_out_dtype_only_fuses_the_cast():
    x = torch.from_numpy(rows_with_zeros(300, 32, seed=4))
    f32 = l2_normalize_rows(x, eps=1e-12)
    bf16 = l2_normalize_rows(x, eps=1e-12, out_dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))
    # With eps 1e-12 it is the model's own normalization, bit for bit.
    assert torch.equal(f32, tt._l2_normalize(x))


def test_other_devices_raise():
    with pytest.raises(ValueError, match="unsupported device"):
        l2_normalize_rows(torch.empty((4, 16), device="meta"))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_build_tables_matches_jax_normalized_tables(dtype):
    arrays = numpy_params()
    model = tt.params_from_numpy(arrays, device="cpu")
    t = tables.build_tables(model, device="cpu", retrieval_dtype=dtype)
    ja, ju = (np.asarray(a) for a in jtt.normalized_tables(jax_params(arrays)[0]))
    want_dtype = torch.float32 if dtype == "f32" else torch.bfloat16
    anime_norm = tables.logical_rows(t.anime_scan)
    for got, want, scan in ((anime_norm, ja, t.anime_scan),
                            (tables.logical_rows(t.user_scan), ju, t.user_scan)):
        assert got.dtype == want_dtype and got.shape == want.shape
        if dtype == "f32":
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
        else:
            # One bf16 ulp: the f32 values may round to either neighbour.
            ulp = np.ldexp(1.0, np.frexp(want)[1] - 8)
            assert (np.abs(got.float().numpy() - want) <= ulp).all()
        assert torch.equal(scan.table, got[scan.perm])
    assert float(anime_norm[5].float().abs().max()) < 1e-5   # the ~zero row stays ~zero
    assert t.anime_qt is None and t.user_qt is None


def test_plain_version_is_what_the_wrapper_runs_on_the_cpu():
    x = torch.from_numpy(rows_with_zeros(64, 16, seed=9))
    assert torch.equal(l2_normalize_rows(x, eps=1e-12, out_dtype=torch.bfloat16),
                       normalize._l2_normalize_rows_plain(x, 1e-12, torch.bfloat16))
