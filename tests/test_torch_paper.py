"""Port parity for the paper's own experiments: LeNet-300-100 on
``TeacherStudent`` (``benchmarks/torch_paper_repro.py`` against
``benchmarks/paper_repro.py``), on the CPU, fed the same numpy inputs.

Held exactly: ``TeacherStudent`` batches, eval sets and stream state; the
``uniform(c, min_block=1)`` plans (block counts, permutations and seeds,
including the divisibility fallback that realises c = 8 as 5 blocks and
c = 16 as the c = 10 plan); FC parameter counts; Fig 4b's rows; the row
names of ``main``; masked-dense off-mask weights (exact zeros after every
step).

Tolerances at float32, as tests/test_torch_train.py: logits atol/rtol 1e-5
(the same products summed in other orders); loss and gradients atol 2e-6,
rtol 1e-4; a 20-step AdamW loss curve rtol 2e-5. From the reference's init
carried across, ``table1(400)`` and the 400-step permutation ablation land
within 0.5 points of the reference's accuracies (2048 eval samples: one
sample is 0.05 points; 400 steps of the tiny per-step differences above can
flip a few borderline samples). The speedup benchmark's cross-check (packed
against masked) holds on the plain route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import paper_repro as jpaper
from benchmarks import torch_paper_repro as tpaper
from benchmarks import torch_speedup as tspeed
from repro.configs.lenet300 import LeNet300 as JLeNet300
from repro.core import policy as jpolicy
from repro.data import TeacherStudent as JTeacherStudent
from repro.optim import OptConfig as JOptConfig
from repro.optim import apply_updates as japply_updates
from repro.optim import init_state as jinit_state
from repro_torch import device as device_lib
from repro_torch import tree as tree_lib
from repro_torch.configs.lenet300 import LeNet300
from repro_torch.convert import params_from_numpy
from repro_torch.core import fold as tfold
from repro_torch.core import policy as tpolicy
from repro_torch.core.mask import make_mask_spec
from repro_torch.data import TeacherStudent
from repro_torch.optim import OptConfig, init_state
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

ATOL = RTOL = 1e-5
G_ATOL, G_RTOL = 2e-6, 1e-4
CURVE_RTOL = 2e-5
ACC_POINTS = 0.5
# (nb, block_in, block_out) of the three layers under uniform(c, min_block=1)
BLOCKS = {4: [(4, 200, 75), (4, 75, 25), (2, 50, 5)],
          8: [(5, 160, 60), (5, 60, 20), (5, 20, 2)],
          10: [(10, 80, 30), (10, 30, 10), (10, 10, 1)],
          16: [(10, 80, 30), (10, 30, 10), (10, 10, 1)]}
FC_PARAMS = {1: 271_410, 4: 68_410, 8: 54_610, 10: 27_510, 16: 27_510}
MODES = ["packed", "masked_dense", "dense"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """LeNet's ops are tiny: more intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _policies(c, **kw):
    if c == 1:
        return jpolicy.DENSE, tpolicy.DENSE
    return (jpolicy.uniform(c, min_block=1, **kw),
            tpolicy.uniform(c, min_block=1, **kw))


def _pair(mode, c=10):
    jp_, tp_ = _policies(1 if mode == "dense" else c)
    jm, tm = JLeNet300(policy=jp_, mode=mode), LeNet300(policy=tp_, mode=mode)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tm, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jm, jparams, tm, tparams


def _batches(n, seed=0):
    data = JTeacherStudent(seed=seed)
    return [data.next() for _ in range(n)]


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return tpaper.to_device(b, torch.device("cpu"))


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=atol, rtol=rtol)


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("kind", ["clusters", "argmax"])
def test_teacher_student_batches_bit_identical(kind):
    ref = JTeacherStudent(seed=3, kind=kind)
    port = TeacherStudent(seed=3, kind=kind)
    for _ in range(3):
        a, b = ref.next(), port.next()
        for k in ("inputs", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    ea, eb = ref.eval_set(2048), port.eval_set(2048)
    for k in ("inputs", "labels"):
        np.testing.assert_array_equal(ea[k], eb[k])
    assert port.state() == ref.state() == {"step": 3, "seed": 3}
    port.restore({"step": 1, "seed": 3})
    again = JTeacherStudent(seed=3, kind=kind)
    again.next()
    np.testing.assert_array_equal(port.next()["inputs"],
                                  again.next()["inputs"])
    with pytest.raises(ValueError):
        port.restore({"step": 0, "seed": 4})


# ----------------------------------------------------------------- policy
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("permuted", [True, False])
@pytest.mark.parametrize("c", [4, 8, 10, 16])
def test_uniform_plans_identical(c, permuted, seed):
    jp_, tp_ = _policies(c, permuted=permuted, seed=seed)
    assert tp_ == tpolicy.CompressionPolicy(c=c, min_block=1,
                                            permuted=permuted, seed=seed)
    tspecs = LeNet300(policy=tp_).specs
    jspecs = JLeNet300(policy=jp_)._specs()
    assert [(s.mask.nb, s.mask.block_in, s.mask.block_out)
            for s in tspecs] == BLOCKS[c]
    for t, j in zip(tspecs, jspecs):
        assert (t.d_in, t.d_out, t.mode) == (j.d_in, j.d_out, j.mode)
        assert (t.mask.nb, t.mask.seed) == (j.mask.nb, j.mask.seed)
        np.testing.assert_array_equal(t.mask.in_perm, j.mask.in_perm)
        np.testing.assert_array_equal(t.mask.out_perm, j.mask.out_perm)
    if c == 16:
        ten = LeNet300(policy=tpolicy.uniform(10, min_block=1,
                                              permuted=permuted, seed=seed))
        for s, t in zip(tspecs, ten.specs):
            assert (s.mask.nb, s.mask.seed) == (t.mask.nb, t.mask.seed)
            np.testing.assert_array_equal(s.mask.in_perm, t.mask.in_perm)
            np.testing.assert_array_equal(s.mask.out_perm, t.mask.out_perm)


def test_policy_constants_match_reference():
    assert tpolicy.KINDS == jpolicy.KINDS
    assert tpolicy.DENSE == tpolicy.CompressionPolicy(c=1)
    assert tpolicy.uniform(8) == tpolicy.CompressionPolicy(c=8, min_block=8)


@pytest.mark.parametrize("c", sorted(FC_PARAMS))
def test_fc_param_count_exact(c):
    jp_, tp_ = _policies(c)
    assert LeNet300(policy=tp_).fc_param_count() == FC_PARAMS[c]
    assert JLeNet300(policy=jp_).fc_param_count() == FC_PARAMS[c]


def test_convert_rejects_a_lenet_tree_of_another_plan():
    jm = JLeNet300(policy=jpolicy.uniform(4, min_block=1))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="LeNet300"):
        params_from_numpy(LeNet300(policy=tpolicy.uniform(10, min_block=1)),
                          tree, device="cpu")


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("mode", MODES)
def test_lenet_logits_loss_and_grads(mode):
    jm, jparams, tm, tparams = _pair(mode)
    b = _batches(1)[0]
    jlogits = jax.jit(jm.apply)(jparams, b["inputs"])
    _close(tm.apply(tparams, _t(b)["inputs"]), jlogits)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jparams, _j(b))
    live = [p.detach().requires_grad_(True) for p in tree_lib.leaves(tparams)]
    tloss = tm.loss(tree_lib.unflatten(tparams, live), _t(b))
    tgrads = torch.autograd.grad(tloss, live)
    _close(tloss, jloss, G_ATOL, G_RTOL)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(tgrads) == 6
    for g, jg in zip(tgrads, jleaves):
        _close(g, jg, G_ATOL, G_RTOL)
    want = np.mean(np.argmax(np.asarray(jlogits), -1) == b["labels"])
    assert float(tm.accuracy(tparams, _t(b))) == pytest.approx(want,
                                                               abs=1 / 50)


@pytest.mark.parametrize("mode", MODES)
def test_lenet_adamw_curve(mode):
    """20 AdamW steps (paper §3.1: batch 50, lr 1e-3) from the carried
    init, the port's step against the reference's jitted one."""
    jm, jparams, tm, tparams = _pair(mode)
    jcfg = JOptConfig(kind="adamw", lr=1e-3)
    jstate = jinit_state(jcfg, jparams)
    mask_fn = jm.reapply_masks if mode == "masked_dense" else None

    @jax.jit
    def jstep(params, ostate, batch):
        loss, grads = jax.value_and_grad(jm.loss)(params, batch)
        params, ostate, _ = japply_updates(jcfg, params, grads, ostate,
                                           mask_fn=mask_fn)
        return params, ostate, loss

    tcfg = OptConfig(kind="adamw", lr=1e-3)
    tstate = init_state(tcfg, tparams)
    tstep = tpaper.make_step(tm, tcfg)
    masks = [None if s.mask is None or s.mode != "masked_dense"
             else tfold.mask_tensor(s.mask, "cpu").bool() for s in tm.specs]
    jl, tl = [], []
    for b in _batches(20):
        jparams, jstate, loss = jstep(jparams, jstate, _j(b))
        jl.append(float(loss))
        tparams, tstate, loss = tstep(tparams, tstate, _t(b))
        tl.append(float(loss))
        for p, m in zip(tparams, masks):
            if m is not None:
                assert torch.all(p["w"][~m] == 0)
    np.testing.assert_allclose(tl, jl, rtol=CURVE_RTOL)
    assert tl[-1] < tl[0]


# -------------------------------------------------------------- figures
def _rows(rows):
    return [tuple(r.split(",", 2)) for r in rows]


@pytest.fixture(scope="module")
def reference_rows():
    """The reference's Table 1 and permutation ablation at 400 steps."""
    return {"table1": jpaper.table1(steps=400),
            "ablation": jpaper.fig4_permutation_ablation(steps=400)}


def _carried_train_lenet(monkeypatch):
    """Make the port's figures start every model from the reference's init
    of the same policy, mode and seed."""
    train = tpaper.train_lenet

    def carried(policy, mode="packed", steps=400, seed=0, **kw):
        jp_ = jpolicy.CompressionPolicy(
            c=policy.c, per_kind=policy.per_kind, min_block=policy.min_block,
            permuted=policy.permuted, seed=policy.seed, mode=policy.mode)
        jparams = JLeNet300(policy=jp_, mode=mode).init(
            jax.random.PRNGKey(seed))
        params = params_from_numpy(LeNet300(policy=policy, mode=mode),
                                   jax.tree.map(np.asarray, jparams),
                                   device="cpu")
        return train(policy, mode, steps, seed, params=params, **kw)

    monkeypatch.setattr(tpaper, "train_lenet", carried)


@pytest.mark.parametrize("figure", ["table1", "ablation"])
def test_figures_match_reference_from_carried_init(figure, reference_rows,
                                                   monkeypatch):
    _carried_train_lenet(monkeypatch)
    fn = {"table1": tpaper.table1,
          "ablation": tpaper.fig4_permutation_ablation}[figure]
    got, want = _rows(fn(400, device="cpu")), _rows(reference_rows[figure])
    assert [r[0] for r in got] == [r[0] for r in want]
    for (name, v, derived), (_, jv, jderived) in zip(got, want):
        if name.endswith("_acc"):
            assert abs(float(v) - float(jv)) <= ACC_POINTS, (name, v, jv)
            assert derived == jderived
        else:       # a difference of two accuracies
            assert abs(float(v) - float(jv)) <= 2 * ACC_POINTS, (name, v, jv)
            assert derived == jderived          # compression, paper=+17.1


def test_fig4b_rows_identical():
    want = jpaper.fig4_masks(n_masks=1, steps=1)[2:]
    assert tpaper.fig4b_rows() == want


def test_main_prints_the_reference_row_names(capsys, reference_rows):
    assert tpaper.main(["--fast", "--sections", "table1", "--device",
                        "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(",")[0] for ln in lines[:-1]] == [
        r[0] for r in _rows(reference_rows["table1"])]
    assert lines[-1] == "device,cpu"
    assert all(float(ln.split(",")[1]) > 90 for ln in lines[:2])


def test_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tpaper.main(["--fast", "--sections", "table1"])
    with pytest.raises(device_lib.NoCudaDevice):
        tpaper.train_lenet(tpolicy.DENSE, steps=1)


# ---------------------------------------------------------------- speedup
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_speedup_cross_check_on_the_plain_route(dtype):
    """The speedup benchmark's check (packed layer against masked layer)
    at 32 tokens, 256 x 128, c = 8."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((32, 256), generator=g).to(dtype)
    w = torch.randn((256, 128), generator=g).to(dtype)
    ok, err = tspeed.cross_check(make_mask_spec(256, 128, 8, seed=0), x, w)
    assert ok and np.isfinite(err)
