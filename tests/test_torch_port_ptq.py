"""The port's PTQ calibration (``ops.avg_pool3d``, ``quant.project_by_iter``,
``nnir.apply(capture=)``, ``ptq/attention.py``, ``ptq/solver.py``,
``ptq/admm.py`` and ``ptq/engine.py::run_ptq``) against the JAX package,
on the same NumPy inputs, on the CPU.

The two cannot agree bit for bit: PyTorch's and XLA's float32 sums run in
other orders (about 1e-6 relative on a matmul, 5e-7 on a Cholesky solve),
and ADMM projects onto a grid at every step, so a tie can flip a code.
So the modules are held tightly and the sweep within bands:

- Grams: rtol 1e-5, atol 1e-3 (measured: |diff| 1.2e-4 at most, 3.2e-7
  of the largest entry);
- ``project_by_iter``: the scale within rtol 1e-6 of the float64 oracle,
  codes equal except where clip(v/a)(n-1) lies within 1e-5 of a .5 tie;
  the blocked loop equal to the step-by-step loop, bit for bit; against
  JAX, no farther than JAX's own float32 error (below);
- ``rho_segments`` equal; ``make_system`` / ``solve_proximal`` rtol 1e-4;
- the attention map and the mask pyramid equal, both tasks;
- ``nnir.apply(capture=)``: captured values within 1e-5;
- ``admm_quantize`` on the same Grams: the port's best iterate at least as
  good as JAX's under a float64 direct-conv oracle, codes equal on at
  least 99 % (measured: all 6912 equal, the port's loss 2.3e-5 lower);
- ``run_ptq`` on the fixture of ``test_ptq_e2e.py``: class voxel counts
  equal, alpha_act within rtol 1e-5 (measured 7.4e-7), every layer loss
  within rtol 1e-2 (measured 6.5e-3 at the 256-level first conv, whose
  float32 quadratic-form loss of 1.3e-4 is mostly cancellation, 5.4e-6
  elsewhere), weight codes equal on at least 99 % (measured: all),
  argmax of the calibrated output agreeing on at least 0.99 (measured:
  all; |diff| 3.8e-6).

The port's best-iterate ranking runs in float64 and must rank six ADMM
candidates like the float64 direct-conv oracle, within 0.25x the smallest
loss gap: the test the JAX package's float32 selector fails
(``tests/test_ptq_solver.py::test_quadratic_selector_ranks_like_direct_f64``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientq_tpu import nnir as jnnir
from efficientq_tpu import ops as jops
from efficientq_tpu import quant as jquant
from efficientq_tpu.models import build_uresq as jbuild
from efficientq_tpu.ptq import PTQHyperParams as JHP
from efficientq_tpu.ptq import admm as jadmm
from efficientq_tpu.ptq import attention as jatt
from efficientq_tpu.ptq import fold_bn as jfold
from efficientq_tpu.ptq import run_ptq as jrun_ptq
from efficientq_tpu.ptq import solver as jsolver
from efficientq_tpu_torch import nnir, ops, quant
from efficientq_tpu_torch.models import UResQConfig, build_uresq, torch_io
from efficientq_tpu_torch.ptq import PTQHyperParams, fold_bn, run_ptq
from efficientq_tpu_torch.ptq import admm, attention, engine, solver

HI = jax.lax.Precision.HIGHEST
TINY = dict(num_mod=2, num_classes=3, depth_config=[1, 1, 1],
            width_config=[4, 8, 4], dilation_config=[1, 1, 1],
            init_stride=(2, 2, 2), drop_rate=0.0, blk_type="mid", ds="simple",
            ds_depth_limit=3, quantize=True, qlvl_w=4, qlvl_act=4,
            q_first=(256, -1), q_last=(256, -1))
GEOMETRIES = [((3, 3, 3), (1, 1, 1), (1, 1, 1)),
              ((3, 3, 3), (2, 2, 1), (1, 1, 1)),
              ((1, 1, 1), (1, 1, 1), (0, 0, 0))]


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_vars(v):
    return jax.tree_util.tree_map(np.asarray, v)


def _tiny_jax(seed=0):
    """The JAX fixture of tests/test_ptq_e2e.py: the tiny quantized UResQ
    with its BN state randomised."""
    from efficientq_tpu.models import UResQConfig as JCfg

    graph = jbuild(JCfg(**TINY))
    variables = jnnir.init(graph, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    for s in variables["state"].values():
        s["mean"] = jnp.asarray(rng.randn(*s["mean"].shape)
                                .astype(np.float32) * 0.1)
        s["var"] = jnp.asarray((np.abs(rng.randn(*s["var"].shape)) * 0.2
                                + 0.9).astype(np.float32))
    return graph, variables


def _codes(kernel, alpha, qlvl):
    """Integer weight codes 0..qlvl-1 of a kernel on the alpha grid."""
    return np.round((np.asarray(kernel, np.float64) / np.asarray(
        alpha, np.float64) + 1.0) * (qlvl - 1) / 2)


# --- ops.avg_pool3d --------------------------------------------------------

@pytest.mark.parametrize("shape,k,s", [((2, 6, 8, 4, 3), 2, None),
                                       ((1, 7, 5, 9, 2), (2, 2, 1), None),
                                       ((1, 6, 6, 6, 2), 3, 2),
                                       ((1, 1, 4, 4, 3), 2, None)])
def test_avg_pool3d_matches_jax(shape, k, s):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(jops.avg_pool3d(jnp.asarray(x), k, s))
    got = ops.avg_pool3d(_t(x), k, s).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# --- quant.project_by_iter -------------------------------------------------

def _tie_free(v, a, num_lvl, lo, hi, rel=0.0):
    """True where t = clip(v/a)(n-1) on the grid lies more than 1e-5 from a
    .5 tie, and more than a relative change ``rel`` of the scale can move
    it."""
    v = np.asarray(v, np.float64)
    a = np.asarray(a, np.float64)
    t = (np.clip(v / a, lo, hi) - lo) * (num_lvl - 1) / (hi - lo)
    margin = 1e-5 + rel * (num_lvl - 1) * max(abs(lo), abs(hi)) / (hi - lo)
    return np.abs(t - np.floor(t) - 0.5) > margin


PROJECTIONS = {"w4": (lambda r: r.randn(64, 200) * 0.1, 4, -1.0, 1.0),
               "a4": (lambda r: np.abs(r.randn(2, 6, 6, 6, 8)), 4, 0.0, 1.0),
               "a4-large": (lambda r: np.abs(r.randn(10, 10000)), 4, 0.0,
                            1.0),
               "w256": (lambda r: r.randn(32, 108) * 0.05, 256, -1.0, 1.0),
               "w2-zero-row": (lambda r: np.concatenate(
                   [np.zeros((1, 50)), r.randn(7, 50)]), 2, -1.0, 1.0)}


def _index(b, n, lo, hi):
    """Grid index 0..n-1 of each grid value."""
    return np.round((np.asarray(b, np.float64) - lo) * (n - 1) / (hi - lo))


def _project_np_rows(v, n, lo, hi):
    out = [quant.project_by_iter_np(row, n, lo, hi) for row in v]
    return (np.array([a for a, _ in out])[:, None],
            np.stack([b for _, b in out]))


@pytest.mark.parametrize("rows", [False, True], ids=["tensor", "rows"])
@pytest.mark.parametrize("name", sorted(PROJECTIONS))
def test_project_by_iter_matches_jax(name, rows):
    """The scale within rtol 1e-6 of the float64 oracle
    (``project_by_iter_np``), codes equal to its codes except at .5 ties,
    and the blocked loop bit-equal to the step-by-step loop.

    Against JAX the scale differs by JAX's own float32 error and no more:
    XLA's float32 sums on the CPU put JAX's scale 1e-6 (3456 elements) to
    2.6e-3 (1e5 elements) from the float64 oracle, where the port's stays
    within 2e-7 (measured over 6 seeds).  So the port's scale must lie
    within |a_jax - a_f64| + 1e-6 a of JAX's, and its codes equal JAX's
    except where that scale difference or a 1e-5 tie can move them."""
    make, n, lo, hi = PROJECTIONS[name]
    v = make(np.random.RandomState(3)).astype(np.float32)
    if rows:
        v = v.reshape(v.shape[0], -1)
        a_j, b_j = jquant.project_by_iter_rows(jnp.asarray(v), n, lo, hi)
        a, b = quant.project_by_iter_rows(_t(v), n, lo, hi)
        a1, b1 = quant.project_by_iter_rows(_t(v), n, lo, hi, block=1)
        a_np, b_np = _project_np_rows(v, n, lo, hi)
        a_j, a_t = np.asarray(a_j)[:, None], a.numpy()[:, None]
    else:
        a_j, b_j = jquant.project_by_iter(jnp.asarray(v), n, lo, hi)
        a, b = quant.project_by_iter(_t(v), n, lo, hi)
        a1, b1 = quant.project_by_iter(_t(v), n, lo, hi, block=1)
        a_np, b_np = quant.project_by_iter_np(v, n, lo, hi)
        a_j, a_t = np.asarray(a_j), a.numpy()
    # the blocked loop is the step-by-step loop (NaN codes of an all-zero
    # row included: 0/0, as in JAX)
    np.testing.assert_array_equal(a.numpy(), a1.numpy())
    np.testing.assert_array_equal(b.numpy(), b1.numpy())
    assert a.dtype == torch.float32 and b.dtype == torch.float32
    np.testing.assert_allclose(a_t, a_np, rtol=1e-6)
    free = _tie_free(v, a_np, n, lo, hi)
    idx = _index(b.numpy(), n, lo, hi)
    np.testing.assert_array_equal(idx[free], _index(b_np, n, lo, hi)[free])
    a_np = np.asarray(a_np, np.float64)
    assert np.all(np.abs(a_t - a_j) <= np.abs(a_j - a_np) + 1e-6 * a_np)
    rel = float(np.max(np.abs(a_t / a_j - 1.0)))
    free = _tie_free(v, a_j, n, lo, hi, rel) & _tie_free(v, a_t, n, lo, hi)
    np.testing.assert_array_equal(idx[free], _index(b_j, n, lo, hi)[free])


def test_project_by_iter_stops_at_max_iter():
    """A step cap that ends inside a block freezes nothing early."""
    v = np.random.RandomState(5).randn(300).astype(np.float32)
    for max_iter in (1, 2, 3, 9):
        a_j, _ = jquant.project_by_iter(jnp.asarray(v), 16, max_iter=max_iter)
        a, _ = quant.project_by_iter(_t(v), 16, max_iter=max_iter, block=4)
        np.testing.assert_allclose(float(a), float(a_j), rtol=1e-6)


# --- nnir.apply(capture=) --------------------------------------------------

def test_apply_capture_matches_jax():
    jg, jv = _tiny_jax()
    jfg, jfv = jfold(jg, jv)
    tg = build_uresq(UResQConfig(**TINY))
    tfg, tfv = fold_bn(tg, torch_io.from_jax_variables(_np_vars(jv),
                                                       device="cpu"))
    x = np.random.RandomState(1).randn(1, 16, 16, 16, 2).astype(np.float32)
    names = [n.name for n in tfg.qconv_nodes()] + ["input"]
    j_out, j_cap = jnnir.apply(jfg, jfv, jnp.asarray(x), precision=HI,
                               capture=names)
    t_out, t_cap = nnir.apply(tfg, tfv, _t(x), capture=names)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5,
                               rtol=1e-5)
    assert set(t_cap) == set(j_cap) == set(names) - {"input"}
    for name in j_cap:
        np.testing.assert_allclose(t_cap[name].numpy(),
                                   np.asarray(j_cap[name]), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    # a captured node that no selected head reaches is still evaluated
    aux = tfg.outputs[0]
    _, cap = nnir.apply(tfg, tfv, _t(x), heads=slice(-1, None),
                        capture=[aux])
    np.testing.assert_allclose(cap[aux].numpy(), t_out[0].numpy())


# --- ptq/attention.py ------------------------------------------------------

@pytest.mark.parametrize("task", ["lits", "brats"])
def test_attention_map_and_pyramid_match_jax(task):
    rng = np.random.RandomState(4)
    out = rng.randn(3, 1, 16, 16, 16, 3).astype(np.float32)
    x0 = rng.randn(1, 16, 16, 16).astype(np.float32)
    x0[:, :4] = 0.0  # background outside the body
    body = x0 != 0.0
    ones = np.ones_like(body)
    j_map, j_nums = jatt.attention_weight_map(jnp.asarray(out[-1]),
                                              jnp.asarray(ones), "p:0.5",
                                              task)
    t_map, t_nums = attention.attention_weight_map(_t(out[-1]), _t(ones),
                                                   "p:0.5", task)
    assert t_nums == j_nums and t_map == j_map
    j_pyr = jatt.mask_pyramid(jnp.asarray(out), jnp.asarray(body), j_map,
                              (2, 2, 2), 5, task)
    t_pyr = attention.mask_pyramid(_t(out), _t(body), t_map, (2, 2, 2), 5,
                                   task)
    assert len(t_pyr) == len(j_pyr) == 5
    for t, j in zip(t_pyr, j_pyr):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for lvl in (t_pyr[1], None):
        shape = (1, 4, 4, 4, 8) if lvl is not None else (1, 3, 4, 4, 8)
        assert attention.match_pyramid_level(t_pyr, shape) is lvl
    np.testing.assert_array_equal(
        attention.pred_brats_con_merge(_t(out[-1])).numpy(),
        np.asarray(jatt.pred_brats_con_merge(jnp.asarray(out[-1]))))


# --- ptq/solver.py ---------------------------------------------------------

def _gram_inputs(ksize, stride, padding, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 6, 7, 5, 3).astype(np.float32)
    out = [(e + 2 * p - k) // s + 1 for e, p, k, s in
           zip((6, 7, 5), padding, ksize, stride)]
    y = rng.randn(2, *out, 4).astype(np.float32)
    att = np.abs(rng.randn(2, *out)).astype(np.float32)
    return x, y, att


@pytest.mark.parametrize("weighted", [False, True], ids=["unw", "att"])
@pytest.mark.parametrize("ksize,stride,padding", GEOMETRIES)
def test_gram_stats_match_jax(ksize, stride, padding, weighted):
    """Chunked two output rows at a time: three chunks at stride 1, two
    (the last ragged) at stride 2."""
    x, y, att = _gram_inputs(ksize, stride, padding)
    att = att if weighted else None
    dim = 3 * int(np.prod(ksize)) + 1
    per_row = y.shape[0] * y.shape[2] * y.shape[3] * dim
    kw = dict(has_bias=True, max_chunk_elems=2 * per_row + 1)
    j = jsolver.compute_gram_stats(
        jnp.asarray(x), jnp.asarray(y),
        None if att is None else jnp.asarray(att), ksize, stride, padding,
        **kw)
    t = solver.compute_gram_stats(_t(x), _t(y),
                                  None if att is None else _t(att), ksize,
                                  stride, padding, **kw)
    for name in ("A_att", "B_att", "A_unw", "B_unw", "yy_att", "yy_unw"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=1e-5,
                                   atol=1e-3, err_msg=name)
    assert t.numel_y == j.numel_y and t.has_bias


def test_kernel_flat_round_trip_matches_jax():
    k = np.random.RandomState(1).randn(2, 3, 2, 5, 4).astype(np.float32)
    flat = solver.kernel_to_flat(_t(k))
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jsolver.kernel_to_flat(jnp.asarray(k))))
    back = solver.flat_to_kernel(flat, k.shape)
    assert back.is_contiguous()
    np.testing.assert_array_equal(back.numpy(), k)


def _stats_pair(has_bias=True, seed=2):
    rng = np.random.RandomState(seed)
    x = np.abs(rng.randn(1, 6, 6, 6, 3)).astype(np.float32)
    y = rng.randn(1, 6, 6, 6, 5).astype(np.float32)
    att = np.abs(rng.randn(1, 6, 6, 6)).astype(np.float32)
    geo = ((3, 3, 3), (1, 1, 1), (1, 1, 1))
    j = jsolver.compute_gram_stats(jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(att), *geo, has_bias=has_bias)
    t = solver.compute_gram_stats(_t(x), _t(y), _t(att), *geo,
                                  has_bias=has_bias)
    return j, t


@pytest.mark.parametrize("has_bias", [True, False], ids=["bias", "nobias"])
def test_system_and_proximal_solve_match_jax(has_bias):
    j, t = _stats_pair(has_bias)
    rng = np.random.RandomState(8)
    dim = t.A_att.shape[0]
    G = (rng.randn(5, dim - int(has_bias)) * 0.1).astype(np.float32)
    W0 = (rng.randn(5, dim) * 0.1).astype(np.float32)
    rho, eta = 20.0, 1.5
    A_j = jsolver.make_system(j, rho, eta, 0.1)
    A_t = solver.make_system(t, rho, eta, 0.1)
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), rtol=1e-4)
    chol_j = jax.scipy.linalg.cho_factor(A_j)
    chol_t = torch.linalg.cholesky(A_t)
    w_j, b_j = jsolver.solve_proximal(chol_j, j, rho, eta, jnp.asarray(G),
                                      jnp.asarray(W0))
    w_t, b_t = solver.solve_proximal(chol_t, t, rho, eta, _t(G), _t(W0))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-4,
                               atol=1e-6)
    W = np.concatenate([G, W0[:, -1:]], 1) if has_bias else G
    for weighted in (False, True):
        np.testing.assert_allclose(
            float(solver.quadratic_mse(t, _t(W), weighted)),
            float(jsolver.quadratic_mse(j, jnp.asarray(W), weighted)),
            rtol=1e-4)


@pytest.mark.parametrize("hp", [dict(), dict(admm_iter=25,
                                             rho_update_interval=10),
                                dict(admm_iter=120, rho=300.0),
                                dict(admm_iter=1)])
def test_rho_segments_match_jax(hp):
    assert admm.rho_segments(PTQHyperParams(**hp)) == \
        jadmm.rho_segments(JHP(**hp))


# --- ptq/admm.py -----------------------------------------------------------

def _layer_case(seed=7, c1=16, c2=16, sp=20):
    """The setup of test_ptq_solver.py's selector test: S = 8000,
    c1k = 433, so the quadratic-form branch ranks the iterates."""
    rng = np.random.RandomState(seed)
    x = np.abs(rng.randn(1, sp, sp, sp, c1)).astype(np.float32)
    w = (rng.randn(3, 3, 3, c1, c2) * 0.1).astype(np.float32)
    b = (rng.randn(c2) * 0.01).astype(np.float32)
    y = np.asarray(jops.conv3d(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b), 1, 1, precision=HI))
    return x, w, b, y


def _f64_oracle(x, y):
    """Explicit float64 im2col (channel-major rows, ones row) and target."""
    sp = x.shape[1]
    xp = np.pad(np.asarray(x, np.float64),
                ((0, 0), (1, 1), (1, 1), (1, 1), (0, 0)))
    cols = [xp[:, kd:kd + sp, kh:kh + sp, kw:kw + sp, :]
            for kd in range(3) for kh in range(3) for kw in range(3)]
    X = np.moveaxis(np.stack(cols), -1, 0).reshape(x.shape[-1] * 27, -1)
    X = np.concatenate([X, np.ones((1, X.shape[1]))], axis=0)
    Y = np.moveaxis(np.asarray(y, np.float64), -1, 1).reshape(y.shape[-1], -1)

    def mse(W):
        return float(np.mean((np.asarray(W, np.float64) @ X - Y) ** 2))
    return mse


@pytest.fixture(scope="module")
def selector_case():
    x, w, b, y = _layer_case()
    geo = ((3, 3, 3), (1, 1, 1), (1, 1, 1))
    stats = solver.compute_gram_stats(_t(x), _t(y), None, *geo)
    return x, w, b, y, stats, _f64_oracle(x, y)


def test_admm_matches_jax_on_the_same_grams(selector_case):
    """Measured: all 6912 codes equal; the port's best iterate's float64
    loss is 2.3e-5 below JAX's (its bias differs by the float32 solves)."""
    x, w, b, y, t_stats, oracle = selector_case
    geo = ((3, 3, 3), (1, 1, 1), (1, 1, 1))
    j_stats = jsolver.compute_gram_stats(jnp.asarray(x), jnp.asarray(y),
                                         None, *geo)
    hp = dict(admm_iter=30, rho_update_interval=10)
    w_flat = np.asarray(jsolver.kernel_to_flat(jnp.asarray(w)))
    Gj, Bj, aj, lj, hj = jadmm.admm_quantize(
        jnp.asarray(w_flat), jnp.asarray(b), j_stats, 4, jnp.float32(1.0),
        JHP(**hp))
    Gt, Bt, at, lt, ht = admm.admm_quantize(_t(w_flat), _t(b), t_stats, 4,
                                            1.0, PTQHyperParams(**hp))
    assert lt.dtype == torch.float64
    assert all(ht[k].shape == (30,) for k in admm.HISTORY_KEYS)
    assert float(ht["loss"].min()) == float(lt)
    np.testing.assert_allclose(ht["rho"].numpy(), np.asarray(hj["rho"]),
                               rtol=1e-6)
    codes_t = _codes(Gt.numpy(), float(at), 4)
    codes_j = _codes(np.asarray(Gj), float(aj), 4)
    assert np.mean(codes_t == codes_j) >= 0.99
    best_t = oracle(np.concatenate([Gt.numpy(), Bt.numpy()[:, None]], 1))
    best_j = oracle(np.concatenate([np.asarray(Gj), np.asarray(Bj)[:, None]],
                                   1))
    assert best_t <= best_j, (best_t, best_j)


def test_ranking_mse_ranks_like_direct_f64(selector_case):
    """The float64 selector ranks six genuine ADMM candidates like the
    float64 direct-conv oracle.  Measured on this case: an error of
    7.9e-6x the smallest loss gap (the float32 quadratic form of the same
    Grams: 0.39x; JAX's float32 selector: 3.67x)."""
    x, w, b, y, stats, oracle = selector_case
    w_flat = solver.kernel_to_flat(_t(w))
    cands = []
    for rho, eta in ((5.0, 1.0), (10.0, 1.0), (20.0, 1.0), (10.0, 0.5),
                     (10.0, 2.0), (40.0, 1.0)):
        hp = PTQHyperParams(admm_iter=25, rho=rho, eta=eta,
                            rho_update_interval=10)
        G, B, _, _, _ = admm.admm_quantize(w_flat, _t(b), stats, 4, 1.0, hp)
        cands.append(torch.cat([G, B[:, None]], 1))
    ranked = solver.make_ranking_mse(stats)
    quad = np.array([float(ranked(W)) for W in cands])
    direct = np.array([oracle(W.numpy()) for W in cands])
    gaps = np.diff(np.sort(direct))
    min_gap = gaps[gaps > 0].min()
    err = np.max(np.abs((quad - quad.mean()) - (direct - direct.mean())))
    assert err < 0.25 * min_gap, (err, min_gap, quad, direct)
    assert np.argsort(quad).tolist() == np.argsort(direct).tolist()
    assert ranked(cands[0]).dtype == torch.float64


CALIBRATIONS = {
    "quadratic": dict(shape=(1, 8, 8, 8, 4), c2=6),
    "direct-conv": dict(shape=(1, 2, 2, 2, 16), c2=8),
    "channel-wise": dict(shape=(1, 8, 8, 8, 4), c2=6, channel_wise=True),
    "bias-corr-att": dict(shape=(1, 8, 8, 8, 4), c2=6, bias_corr=True,
                          att=True),
    "no-act-quant": dict(shape=(1, 6, 6, 6, 3), c2=5, qlvl_act=None),
}


@pytest.mark.parametrize("name", sorted(CALIBRATIONS))
def test_calibrate_layer_matches_jax(name):
    case = dict(CALIBRATIONS[name])
    shape, c2 = case.pop("shape"), case.pop("c2")
    qlvl_act = case.pop("qlvl_act", 4)
    use_att = case.pop("att", False)
    rng = np.random.RandomState(11)
    x = np.abs(rng.randn(*shape)).astype(np.float32)
    k = (rng.randn(3, 3, 3, shape[-1], c2) * 0.2).astype(np.float32)
    b = (rng.randn(c2) * 0.05).astype(np.float32)
    y = np.asarray(jops.conv3d(jnp.asarray(x), jnp.asarray(k),
                               jnp.asarray(b), 1, 1, precision=HI))
    y = y + 0.1 * rng.randn(*y.shape).astype(np.float32)
    att = (rng.rand(*y.shape[:-1]).astype(np.float32) + 0.5
           if use_att else None)
    kw = dict(ksize=(3, 3, 3), stride=(1, 1, 1), padding=(1, 1, 1),
              dilation=(1, 1, 1), qlvl_w=4, has_bias=True, qlvl_act=qlvl_act)
    j = jadmm.calibrate_layer(jnp.asarray(x), jnp.asarray(y), jnp.asarray(k),
                              jnp.asarray(b),
                              None if att is None else jnp.asarray(att),
                              hp=JHP(admm_iter=30, **case), **kw)
    t = admm.calibrate_layer(_t(x), _t(y), _t(k), _t(b),
                             None if att is None else _t(att),
                             hp=PTQHyperParams(admm_iter=30, **case), **kw)
    np.testing.assert_allclose(t["alpha_w"].numpy(),
                               np.asarray(j["alpha_w"]), rtol=1e-5)
    if qlvl_act is None:
        assert t["alpha_act"] is None
    else:
        np.testing.assert_allclose(float(t["alpha_act"]),
                                   float(j["alpha_act"]), rtol=1e-5)
    a_bc = np.asarray(j["alpha_w"]).reshape(1, 1, 1, 1, -1)
    assert np.mean(_codes(t["kernel"].numpy(), a_bc, 4)
                   == _codes(j["kernel"], a_bc, 4)) >= 0.99
    for key in ("loss_reported", "loss_unweighted", "loss_relative"):
        np.testing.assert_allclose(float(t[key]), float(j[key]), rtol=1e-2,
                                   err_msg=key)
    np.testing.assert_allclose(t["bias"].numpy(), np.asarray(j["bias"]),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(t["out_q"].numpy(), np.asarray(j["out_q"]),
                               rtol=1e-3, atol=1e-4)
    assert set(t["seconds"]) == {"gram", "admm", "rest"}


def test_unported_options_raise():
    x = torch.zeros(1, 4, 4, 4, 2)
    g = build_uresq(UResQConfig(**TINY))
    v = nnir.init(g, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        run_ptq(g, v, x, task="lits", init_stride=2, device="cpu",
                mesh=object())


def test_calibrate_layer_act_search_runs():
    """The offset-grid search that raised before this slice: it runs and
    returns an int32 act_k in 0..K (its parity with JAX:
    tests/test_torch_port_ptq_ext.py)."""
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 4, 4, 4, 2)
                         .astype(np.float32))
    res = admm.calibrate_layer(x, x, torch.ones(3, 3, 3, 2, 2) * 0.1, None,
                               None, ksize=(3, 3, 3), stride=(1, 1, 1),
                               padding=(1, 1, 1), dilation=(1, 1, 1),
                               qlvl_w=4, has_bias=False,
                               hp=PTQHyperParams(admm_iter=2), qlvl_act=4,
                               act_search=2)
    assert res["act_k"].dtype == torch.int32
    assert 0 <= int(res["act_k"]) <= 2
    assert np.isfinite(float(res["loss_reported"]))


@pytest.mark.parametrize("kw", [dict(granularity="block"),
                                dict(granularity="block", block_target="fp"),
                                dict(act_offset=1)],
                         ids=["block", "block-fp", "act-offset"])
def test_run_ptq_options_run(kw):
    """run_ptq's block granularity (both targets) and offset grids, which
    raised before this slice, calibrate every layer with finite losses
    (their parity with JAX: tests/test_torch_port_ptq_ext.py)."""
    g = build_uresq(UResQConfig(**TINY))
    v = nnir.init(g, 0, device="cpu")
    x = np.random.RandomState(1).randn(1, 16, 16, 16, 2).astype(np.float32)
    fg, qv, rep = run_ptq(g, v, x, task="lits", init_stride=(2, 2, 2),
                          hp=PTQHyperParams(admm_iter=2), device="cpu", **kw)
    assert len(rep.layer_losses) == len(fg.qconv_nodes())
    assert all(np.isfinite(loss) for _, loss in rep.layer_losses)
    searched = [n for n in fg.qconv_nodes()
                if "act_k" in qv["params"][n.name]]
    assert bool(searched) == ("act_offset" in kw)


# --- ptq/engine.py::run_ptq ------------------------------------------------

@pytest.fixture(scope="module")
def sweeps():
    """JAX's and the port's run_ptq on the fixture of test_ptq_e2e.py, the
    same weights (carried over as NumPy) and calibration batch."""
    jg, jv = _tiny_jax()
    x = np.random.RandomState(7).randn(1, 16, 16, 16, 2).astype(np.float32)
    jfg, jqv, jrep = jrun_ptq(jg, jv, jnp.asarray(x), task="lits",
                              init_stride=(2, 2, 2), hp=JHP(admm_iter=40))
    tg = build_uresq(UResQConfig(**TINY))
    tv = torch_io.from_jax_variables(_np_vars(jv), device="cpu")
    tfg, tqv, trep = run_ptq(tg, tv, x, task="lits", init_stride=(2, 2, 2),
                             hp=PTQHyperParams(admm_iter=40), device="cpu")
    return dict(x=x, jax=(jfg, _np_vars(jqv), jrep), port=(tfg, tqv, trep),
                graph=tg, variables=tv)


def test_run_ptq_report_matches_jax(sweeps):
    _, _, jrep = sweeps["jax"]
    tfg, _, trep = sweeps["port"]
    assert trep.class_voxel_nums == jrep.class_voxel_nums
    assert [n for n, _ in trep.layer_losses] == \
        [n for n, _ in jrep.layer_losses] == \
        [n.name for n in tfg.qconv_nodes()]
    for (name, lt), (_, lj) in zip(trep.layer_losses, jrep.layer_losses):
        assert np.isfinite(lt)
        np.testing.assert_allclose(lt, lj, rtol=1e-2, err_msg=name)
    for (name, lt), (_, lj) in zip(trep.layer_rel_losses,
                                   jrep.layer_rel_losses):
        np.testing.assert_allclose(lt, lj, rtol=1e-2, err_msg=name)
    assert set(trep.layer_histories) == set(jrep.layer_histories)
    assert set(trep.layer_seconds) == set(jrep.layer_histories)
    assert trep.time_cost_line().endswith("min.")
    assert len(trep.layer_loss_lines()) == len(trep.layer_losses)


def test_run_ptq_parameters_match_jax(sweeps):
    jfg, jqv, _ = sweeps["jax"]
    tfg, tqv, _ = sweeps["port"]
    same = total = 0
    for node in tfg.qconv_nodes():
        q = node.attrs["qcfg"]
        tp, jp = tqv["params"][node.name], jqv["params"][node.name]
        if q.q_act:
            np.testing.assert_allclose(float(tp["alpha_act"]),
                                       float(jp["alpha_act"]), rtol=1e-5,
                                       err_msg=node.name)
        np.testing.assert_allclose(float(tp["alpha_w"]),
                                   float(jp["alpha_w"]), rtol=1e-5,
                                   err_msg=node.name)
        ct = _codes(tp["kernel"].numpy(), float(tp["alpha_w"]), q.qlvl_w)
        cj = _codes(jp["kernel"], float(jp["alpha_w"]), q.qlvl_w)
        same += int((ct == cj).sum())
        total += ct.size
    assert same / total >= 0.99, same / total


def test_run_ptq_output_matches_jax(sweeps):
    _, _, jrep = sweeps["jax"]
    _, _, trep = sweeps["port"]
    np.testing.assert_allclose(trep.output_fp.numpy(),
                               np.asarray(jrep.output_fp), atol=1e-5,
                               rtol=1e-5)
    agree = np.mean(trep.output_q[-1].numpy().argmax(-1)
                    == np.asarray(jrep.output_q[-1]).argmax(-1))
    assert agree >= 0.99, agree


def test_run_ptq_improves_over_naive(sweeps):
    """test_ptq_e2e.py's own checks, on the port: the quantized forward
    equals the sweep's output, and beats naive fake quantization."""
    x = _t(sweeps["x"])
    tfg, tqv, trep = sweeps["port"]
    out_q = nnir.apply(tfg, tqv, x, mode="quantized")
    np.testing.assert_allclose(out_q.numpy(), trep.output_q.numpy(),
                               atol=1e-3, rtol=1e-3)
    nfg, nfv = fold_bn(sweeps["graph"], sweeps["variables"])
    for name, p in nfv["params"].items():
        if "alpha_act" in p:
            p["alpha_act"] = tqv["params"][name]["alpha_act"]
    out_naive = nnir.apply(nfg, nfv, x, mode="fq")
    err_q = float(torch.mean((out_q[-1] - trep.output_fp[-1]) ** 2))
    err_naive = float(torch.mean((out_naive[-1] - trep.output_fp[-1]) ** 2))
    assert np.isfinite(err_q) and err_q < err_naive, (err_q, err_naive)


def test_run_ptq_weights_on_grid(sweeps):
    tfg, tqv, _ = sweeps["port"]
    for node in tfg.qconv_nodes():
        q = node.attrs["qcfg"]
        p = tqv["params"][node.name]
        alpha = float(p["alpha_w"])
        vals = p["kernel"].numpy().ravel()
        grid = np.linspace(-1, 1, q.qlvl_w) * alpha
        dist = np.min(np.abs(vals[:, None] - grid[None, :]), axis=1)
        assert dist.max() < 1e-4, node.name


def test_run_ptq_leaves_inputs_and_tf32_flags_alone(sweeps, monkeypatch):
    """run_ptq folds copies, holds exact_f32 through the sweep and restores
    the caller's TF32 flags."""
    seen = []
    real = engine.calibrate_layer

    def spy(*a, **k):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return real(*a, **k)

    monkeypatch.setattr(engine, "calibrate_layer", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    g, v = sweeps["graph"], sweeps["variables"]
    before = {k: dict(p) for k, p in v["params"].items()}
    run_ptq(g, v, sweeps["x"], task="brats", init_stride=(2, 2, 2),
            hp=PTQHyperParams(admm_iter=2), device="cpu")
    assert seen and all(f == (False, False) for f in seen)
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
    for k, p in v["params"].items():
        assert all(p[n] is before[k][n] for n in p), k


def test_apply_qlvl_overrides():
    g = build_uresq(UResQConfig(**TINY))
    name = g.qconv_nodes()[1].name
    g2 = engine.apply_qlvl_overrides(g, {name: (16, 8)})
    q = g2.node(name).attrs["qcfg"]
    assert (q.qlvl_w, q.qlvl_act) == (16, 8)
    assert g.node(name).attrs["qcfg"].qlvl_w == 4
    with pytest.raises(ValueError, match="unknown"):
        engine.apply_qlvl_overrides(g, {"nope": (4, 4)})
