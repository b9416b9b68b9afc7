"""ops/dense_adam.py's plain path on the CPU: the update that trainer.dense_step,
lazy._head_adam and the psum step run (the kernel itself: tests/test_torch_cuda.py).

* dense_adam_ on any list of f32 tensors (table shapes, ragged ones, 0-dim
  scalars) equals the chain dense_step applied one parameter at a time, bit
  for bit: it is that chain;
* the head scalars (lazy._head_adam, which fused_step and lazy_step call)
  now take the same chain, where each scalar used to take lr before the
  division: the moments equal the old update's bit for bit, and a parameter
  differs by at most one rounding of the step's size and one of its own
  value (two f32 roundings in another order);
* against optax.scale_by_adam (the JAX package's optimizer) with -lr applied
  after, to 2e-6 relative: XLA orders and fuses the arithmetic its own way;
* the wrapper raises on what the kernel does not take, on every device.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anime_recommendations_tpu_torch.models.two_tower import HEAD_KEYS
from anime_recommendations_tpu_torch.ops.dense_adam import B1, B2, KERAS_ADAM_EPS, dense_adam_
from anime_recommendations_tpu_torch.ops.fused_adam import scalar_row
from anime_recommendations_tpu_torch.train import trainer as tr
from anime_recommendations_tpu_torch.train.lazy import _head_adam

torch.set_num_threads(2)

SHAPES = {
    "tables_and_head": [(300, 16), (120, 16), (), (), (), ()],
    "ragged": [(1001, 3), (7,), (5,), (), (4097,)],
    "empty_beside_others": [(0,), (9, 2), ()],
    "one_scalar": [()],
    "eight": [(3,), (4,), (5,), (6,), (7,), (8,), (), (2, 2)],
}


def quads(shapes, seed):
    """(p, g, mu, nu) per shape from a seed: moments as after a few steps."""
    rng = np.random.default_rng(seed)
    t = lambda sh, s: torch.from_numpy(np.asarray(rng.standard_normal(sh) * s, np.float32))
    return [(t(sh, 0.05), t(sh, 1e-3), t(sh, 1e-4), t(sh, 1e-4).square())
            for sh in shapes]


def old_dense_chain(params, grads, mus, nus, lr, bc1, bc2):
    """trainer.dense_step's update as it was written, one parameter at a time."""
    with torch.no_grad():
        for p, g, mu, nu in zip(params, grads, mus, nus):
            mu.mul_(B1).add_(g * (1 - B1))
            nu.mul_(B2).add_(torch.square(g) * (1 - B2))
            p.sub_((mu / bc1) / (torch.sqrt(nu / bc2) + KERAS_ADAM_EPS) * lr)


def old_scalar_adam(p, mu, nu, g, bc1, bc2, lr):
    """lazy._scalar_adam, the head scalars' update before dense_adam_."""
    mu_new = B1 * mu + (1.0 - B1) * g
    nu_new = B2 * nu + (1.0 - B2) * (g * g)
    p.copy_(p - lr * (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + KERAS_ADAM_EPS))
    mu.copy_(mu_new)
    nu.copy_(nu_new)


@pytest.mark.parametrize("step", [1, 2, 700])
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_plain_path_is_the_dense_chain_bit_for_bit(case, step):
    ours = quads(SHAPES[case], seed=step)
    ref = [tuple(t.clone() for t in q) for q in ours]
    scal = scalar_row(step, 3e-4, "cpu")
    dense_adam_(*zip(*ours), scal)
    old_dense_chain(*zip(*ref), scal[0], scal[1], scal[2])
    for q, r in zip(ours, ref):
        for a, b in zip(q, r):
            assert torch.equal(a, b)
    assert not torch.equal(ours[-1][0], quads(SHAPES[case], seed=step)[-1][0])


def test_dense_step_is_the_old_chain_bit_for_bit():
    """Three dense_steps against the same steps with the chain written out:
    every state tensor bit for bit (device_loop's epoch tests hold the
    epoch to the chain as well)."""
    make = lambda: tr.init_train_state(300, 120, 16, generator=torch.Generator().manual_seed(3),
                                       device="cpu")
    ours, ref = make(), make()
    rng = np.random.default_rng(5)
    for step in range(1, 4):
        cols = [torch.from_numpy(rng.integers(0, 300, 256).astype(np.int32)),
                torch.from_numpy(rng.integers(0, 120, 256).astype(np.int32)),
                torch.from_numpy(rng.uniform(0, 1, 256).astype(np.float32)), torch.ones(256)]
        scal = scalar_row(step, 1e-3, "cpu")
        loss, _ = tr.dense_step(ours, *cols, scal, 1e-4)
        model = ref.model
        params = [getattr(model, k) for k in tr.PARAM_KEYS]
        ref_loss, (_, new_bn) = tr.loss_and_metrics(model, model.bn_state(), *cols, 1e-4, True)
        grads = torch.autograd.grad(ref_loss, params)
        old_dense_chain(params, grads, [ref.adam.mu[k] for k in tr.PARAM_KEYS],
                        [ref.adam.nu[k] for k in tr.PARAM_KEYS], scal[0], scal[1], scal[2])
        with torch.no_grad():
            tr._keep_bn(model, new_bn)
        assert torch.equal(loss, ref_loss.detach())
    got, want = tr.train_state_to_numpy(ours), tr.train_state_to_numpy(ref)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_head_adam_moves_lr_to_the_chain_order(seed):
    """Ten _head_adam steps against the old per-scalar update from one
    state: mu and nu bit for bit; each parameter within one f32 rounding of
    itself plus two of the step's size (lr now multiplies last)."""
    state = tr.init_train_state(20, 10, 4, generator=torch.Generator().manual_seed(seed),
                                device="cpu")
    old = {k: [getattr(state.model, k).detach().clone(), state.adam.mu[k].clone(),
               state.adam.nu[k].clone()] for k in HEAD_KEYS}
    rng = np.random.default_rng(seed)
    for step in range(1, 11):
        d_head = [torch.tensor(np.float32(rng.standard_normal() * 1e-2)) for _ in HEAD_KEYS]
        scal = scalar_row(step, 1e-3, "cpu")
        _head_adam(state, d_head, scal)
        for k, g in zip(HEAD_KEYS, d_head):
            p_old = old[k][0].clone()
            old_scalar_adam(*old[k], g, scal[1], scal[2], scal[0])
            p, mu, nu = getattr(state.model, k).detach(), state.adam.mu[k], state.adam.nu[k]
            assert torch.equal(mu, old[k][1]) and torch.equal(nu, old[k][2]), (k, step)
            upd = abs(float(p_old) - float(old[k][0]))
            tol = np.spacing(np.float32(abs(float(old[k][0])))) + 2 * np.spacing(np.float32(upd))
            assert abs(float(p) - float(old[k][0])) <= tol, (k, step)
            old[k][0].copy_(p)   # compare each step from the same parameter


@pytest.mark.parametrize("step", [1, 50])
def test_plain_path_matches_optax(step):
    """One update of a state as after step - 1 steps against
    optax.scale_by_adam(B1, B2, KERAS_ADAM_EPS) then -lr."""
    ours = quads(SHAPES["tables_and_head"], seed=7)
    lr = 5e-4
    opt = optax.scale_by_adam(b1=B1, b2=B2, eps=KERAS_ADAM_EPS)
    jx = lambda t: jnp.array(t.numpy(), copy=True)   # not a view of what dense_adam_ updates
    params = [jx(q[0]) for q in ours]
    state = opt.init(params)._replace(count=jnp.asarray(step - 1, jnp.int32),
                                      mu=[jx(q[2]) for q in ours], nu=[jx(q[3]) for q in ours])
    updates, state = opt.update([jx(q[1]) for q in ours], state)
    dense_adam_(*zip(*ours), scalar_row(step, lr, "cpu"))
    for q, p, u, mu, nu in zip(ours, params, updates, state.mu, state.nu):
        np.testing.assert_allclose(q[0].numpy(), np.asarray(p - lr * u), rtol=2e-6, atol=1e-9)
        np.testing.assert_allclose(q[2].numpy(), np.asarray(mu), rtol=2e-6, atol=1e-12)
        np.testing.assert_allclose(q[3].numpy(), np.asarray(nu), rtol=2e-6, atol=1e-16)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16, torch.float16],
                         ids=["f64", "bf16", "f16"])
@pytest.mark.parametrize("which", range(4), ids=["param", "grad", "mu", "nu"])
def test_wrapper_raises_on_a_tensor_that_is_not_f32(which, dtype):
    quad = list(quads([(6, 4)], seed=0)[0])
    quad[which] = quad[which].to(dtype)
    with pytest.raises(TypeError, match="f32"):
        dense_adam_(*([t] for t in quad), scalar_row(1, 1e-3, "cpu"))


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    scal = scalar_row(1, 1e-3, "cpu")
    nine = quads([(2,)] * 9, seed=0)
    with pytest.raises(ValueError, match="1 to 8"):
        dense_adam_(*zip(*nine), scal)
    with pytest.raises(ValueError, match="1 to 8"):
        dense_adam_([], [], [], [], scal)
    p, g, mu, nu = quads([(6, 4)], seed=0)[0]
    with pytest.raises(ValueError, match="1 to 8"):
        dense_adam_([p], [g], [mu, mu], [nu], scal)
    with pytest.raises(ValueError, match="shape"):
        dense_adam_([p], [g[:3]], [mu], [nu], scal)
    with pytest.raises(ValueError, match="scal"):
        dense_adam_([p], [g], [mu], [nu], scal[:3])
    with pytest.raises(ValueError, match="scal"):
        dense_adam_([p], [g], [mu], [nu], scal.double())
    with pytest.raises(ValueError, match="meta"):
        dense_adam_([p], [g.to("meta")], [mu], [nu], scal)
