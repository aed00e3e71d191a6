"""Port parity, masked-dense training ops: the plain versions of the masked
matmul (both orientations) and of the masked weight gradient against the
JAX Pallas kernels run in interpret mode (as tests/test_kernels.py runs
them) and the jnp oracles; the autograd rules of ``masked_matmul`` and
``bdmm`` against ``jax.grad`` of ``repro.kernels.ops`` on the jnp route; and
the fold of masked-dense weights against ``repro.core.fold``. The CUDA
kernels against their plain versions are in tests/test_torch_cuda.py.

Tolerance at float32: atol 2e-5, rtol 1e-5 for the forward products (as
tests/test_torch_kernels.py: the same products summed in another order) and
atol 1e-5, rtol 1e-4 for gradients, which pass through one more product and
the activation's derivative. Folding only moves values, so it is held
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fold as jfold
from repro.core import mask as jmask
from repro.core import mpd as jmpd
from repro.kernels import masked_matmul as jmm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import fold as tfold
from repro_torch.core import mask as tmask
from repro_torch.core import mpd as tmpd
from repro_torch.kernels import masked_matmul as tmm
from repro_torch.kernels import ops
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

ATOL, RTOL = 2e-5, 1e-5
G_ATOL, G_RTOL = 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(m, d_in, d_out, nb, seed):
    """x, w, a permuted block mask and a bias, from numpy."""
    rng = np.random.default_rng(seed)
    spec = jmask.make_mask_spec(d_in, d_out, nb, seed=seed)
    mask = jmask.mask_dense(spec, np.float32)
    x = rng.standard_normal((m, d_in)).astype(np.float32)
    w = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    b = (0.1 * rng.standard_normal((d_out,))).astype(np.float32)
    return x, w, mask, b


SHAPES = [  # (m, d_in, d_out, nb): square, odd m, wide and tall, K=3*bk
    (16, 32, 32, 4), (13, 24, 40, 4), (7, 48, 24, 8), (32, 96, 64, 2)]


@pytest.mark.parametrize("act", [None, "silu", "gelu", "relu"])
@pytest.mark.parametrize("shape", SHAPES)
def test_masked_matmul_plain_matches_jax(shape, act):
    """``ops.masked_matmul`` (the plain version on CPU tensors) against the
    Pallas kernel in interpret mode and the jnp oracle, bias and each
    activation of the kernel epilogue."""
    x, w, mask, b = _case(*shape, seed=sum(shape))
    got = ops.masked_matmul(_t(x), _t(w), _t(mask).to(torch.uint8), _t(b),
                            activation=act).numpy()
    args = [jnp.asarray(a) for a in (x, w, mask, b)]
    kern = jmm.masked_matmul(*args, activation=act, bm=8, bn=8, bk=16,
                             interpret=True)
    want = jref.masked_matmul_ref(*args, activation=act)
    np.testing.assert_allclose(got, np.asarray(kern), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_masked_matmul_transposed_plain_matches_jax(shape):
    """``g @ (M∘W)ᵀ``, the input gradient, against the kernel's
    ``transpose_rhs`` form in interpret mode."""
    m, d_in, d_out, nb = shape
    _, w, mask, _ = _case(*shape, seed=sum(shape) + 1)
    g = np.random.default_rng(5).standard_normal((m, d_out)).astype(np.float32)
    got = ops.masked_matmul_t(_t(g), _t(w), _t(mask).to(torch.uint8)).numpy()
    kern = jmm.masked_matmul(jnp.asarray(g), jnp.asarray(w),
                             jnp.asarray(mask), transpose_rhs=True, bm=8,
                             bn=8, bk=8, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_sddmm_plain_matches_jax(shape):
    """``(xᵀ @ g) ∘ M`` against the SDDMM kernel in interpret mode (the
    token axis split over several grid steps); off-mask entries are 0."""
    m, d_in, d_out, nb = shape
    x, _, mask, _ = _case(*shape, seed=sum(shape) + 2)
    g = np.random.default_rng(6).standard_normal((m, d_out)).astype(np.float32)
    got = ops.sddmm_masked(_t(x), _t(g), _t(mask).to(torch.uint8)).numpy()
    kern = jmm.sddmm_masked(jnp.asarray(x), jnp.asarray(g), jnp.asarray(mask),
                            bi=8, bo=8, bt=4, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), atol=ATOL, rtol=RTOL)
    assert np.all(got[mask == 0] == 0.0)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("act", [None, "silu", "gelu"])
def test_masked_matmul_grads_match_jax(act, bias):
    """``torch.autograd.grad`` of ``sum(masked_matmul(...)**2)`` against
    ``jax.grad`` of the reference's custom VJP (jnp route), with leading
    batch axes; off-mask weight gradients are exact zeros and the mask
    gets none."""
    x, w, mask, b = _case(12, 32, 48, 4, seed=9)
    x = x.reshape(3, 4, 32)
    jops.set_backend("jnp")

    def jloss(x_, w_, b_):
        y = jops.masked_matmul(x_, w_, jnp.asarray(mask), b_ if bias else None,
                               activation=act)
        return jnp.sum(y ** 2)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (_t(a).requires_grad_(True) for a in (x, w, b))
    tmask_ = _t(mask).to(torch.uint8)
    y = ops.masked_matmul(tx, tw, tmask_, tb if bias else None,
                          activation=act)
    wanted = (tx, tw, tb) if bias else (tx, tw)
    tgrads = torch.autograd.grad((y ** 2).sum(), wanted)
    for got, want in zip(tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=G_ATOL, rtol=G_RTOL)
    assert np.all(tgrads[1].numpy()[mask == 0] == 0.0)


@pytest.mark.parametrize("act", [None, "silu"])
def test_bdmm_grads_match_jax(act):
    """The packed form's autograd rule (``dx`` a bdmm with transposed
    blocks, ``dwp`` an einsum, bias summed) against ``jax.grad``."""
    rng = np.random.default_rng(4)
    nb, bi, bo = 4, 8, 12
    x = rng.standard_normal((2, 5, nb * bi)).astype(np.float32)
    wp = (rng.standard_normal((nb, bi, bo)) / np.sqrt(bi)).astype(np.float32)
    b = (0.1 * rng.standard_normal((nb * bo,))).astype(np.float32)
    jops.set_backend("jnp")
    jgrads = jax.grad(
        lambda *a: jnp.sum(jops.bdmm(*a, activation=act) ** 2),
        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(b))
    targs = [_t(a).requires_grad_(True) for a in (x, wp, b)]
    y = ops.bdmm(*targs, activation=act)
    tgrads = torch.autograd.grad((y ** 2).sum(), targs)
    for got, want in zip(tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=G_ATOL, rtol=G_RTOL)


def test_no_grad_forward_is_one_fused_call():
    """Outside differentiation the forward is the fused plain call itself
    (bias and activation inside); under grad the same values come through
    the autograd rule."""
    x, w, mask, b = _case(8, 16, 24, 4, seed=2)
    args = (_t(x), _t(w), _t(mask).to(torch.uint8), _t(b))
    with torch.no_grad():
        y0 = ops.masked_matmul(*args, activation="silu")
    assert y0.grad_fn is None
    xg = args[0].clone().requires_grad_(True)
    y1 = ops.masked_matmul(xg, *args[1:], activation="silu")
    assert type(y1.grad_fn).__name__ == "_MaskedMatmulBackward"
    torch.testing.assert_close(y1.detach(), y0, atol=0, rtol=0)


def test_masked_kernel_rejects_bad_inputs():
    x = torch.zeros(4, 16)
    w = torch.zeros(16, 8)
    with pytest.raises(ValueError):        # a float mask is not a binary one
        tmm.masked_matmul(x, w, torch.ones(16, 8))
    with pytest.raises(ValueError):        # K mismatch
        tmm.masked_matmul(x, torch.zeros(8, 8), torch.ones(8, 8, dtype=torch.uint8))
    with pytest.raises(ValueError):        # the kernel takes no CPU tensor
        tmm.masked_matmul(x, w, torch.ones(16, 8, dtype=torch.uint8))
    with pytest.raises(ValueError):
        tmm.sddmm_masked(x, torch.zeros(4, 8), torch.ones(16, 8, dtype=torch.uint8))


# ---------------------------------------------------------------------- fold
FOLD_SPECS = [(32, 48, 4, True), (24, 24, 3, True), (16, 32, 2, False)]


@pytest.mark.parametrize("dims", FOLD_SPECS)
def test_fold_unfold_residual_match_jax(dims):
    """``fold``, ``unfold``, ``fold_residual`` and ``inter_layer_perm`` give
    the reference's arrays on the same masks, stacked leading axes
    included; the device mask equals ``mask_dense``."""
    d_in, d_out, nb, permuted = dims
    jspec = jmask.make_mask_spec(d_in, d_out, nb, seed=3, permuted=permuted)
    tspec = tmask.make_mask_spec(d_in, d_out, nb, seed=3, permuted=permuted)
    np.testing.assert_array_equal(
        tfold.mask_tensor(tspec, "cpu").numpy(),
        jmask.mask_dense(jspec, np.float32).astype(np.uint8))
    rng = np.random.default_rng(d_in)
    w = rng.standard_normal((d_in, d_out)).astype(np.float32)
    wm = w * jmask.mask_dense(jspec, np.float32)

    packed = tfold.fold(tspec, _t(wm))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jfold.fold(jspec, wm)))
    np.testing.assert_array_equal(tfold.unfold(tspec, packed).numpy(), wm)
    np.testing.assert_array_equal(
        tfold.unfold(tspec, packed).numpy(),
        np.asarray(jfold.unfold(jspec, jnp.asarray(packed.numpy()))))
    stacked = np.stack([wm, 2 * wm])
    np.testing.assert_array_equal(tfold.fold(tspec, _t(stacked))[1].numpy(),
                                  2 * packed.numpy())
    assert tfold.fold_residual(tspec, _t(wm)) == 0.0
    np.testing.assert_allclose(tfold.fold_residual(tspec, _t(w)),
                               jfold.fold_residual(jspec, w), rtol=1e-6)
    # the layer-level forms: from_dense (masked or folded) and to_packed
    for mode in ("masked_dense", "packed"):
        js = jmpd.MPDLinearSpec(d_in, d_out, jspec, mode=mode)
        ts = tmpd.MPDLinearSpec(d_in, d_out, tspec, mode=mode)
        jl, tl = jmpd.from_dense(js, w), tmpd.from_dense(ts, _t(w))
        if mode == "masked_dense":
            jl, tl = jmpd.to_packed(js, jl), tmpd.to_packed(ts, tl)
        for k in ("w", "b"):
            np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]))
    nxt_j = jmask.make_mask_spec(d_out, d_in, nb, seed=4)
    nxt_t = tmask.make_mask_spec(d_out, d_in, nb, seed=4)
    np.testing.assert_array_equal(tfold.inter_layer_perm(tspec, nxt_t),
                                  jfold.inter_layer_perm(jspec, nxt_j))
