"""The port's utils, testing helpers and agg_bench twin against the JAX
package on the same numpy inputs: the numpy oracles nls_gt/agg_gt
(bitwise), checks (gradcheck on a torch function), the DAVIS fixture
(bitwise), inds, mask, misc (flow2inds/inds2flow), pads (same_padded at
6-D against jnp.pad), vid_io and viz_inds, the debug checks (the first
three tests of tests/utils/test_debug_checks.py), the timers, memory
probes and RecordIt on CPU tensors, agg_bench.run on the CPU and the
twin's five aggregators at 64^2 against JAX's (atol = rtol = 1e-4), and
the package itself: a
counterpart of every module of the JAX package but the named exclusions,
no import of JAX, and an import with cv2, PIL and matplotlib missing."""

import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import stnls_tpu
import stnls_tpu_torch
from stnls_tpu_torch import agg_bench
from stnls_tpu_torch.testing import nls_gt, agg_gt, checks, data
from stnls_tpu_torch.utils import debug, inds as t_inds, mask as t_mask, \
    misc, pads, vid_io, viz_inds, timer, mem, bench

from torch_port_helpers import to_torch, to_np, assert_close

REPO = Path(__file__).resolve().parents[2]


def test_oracles_bitwise_equal_to_jax(rng):
    from stnls_tpu.testing import nls_gt as j_nls, agg_gt as j_agg
    B, HD, T, F, H, W, K = 1, 1, 2, 2, 5, 5, 3
    vid0, vid1 = (rng.standard_normal((B, HD, T, F, H, W)) for _ in range(2))
    flows = 1.3 * rng.standard_normal((B, HD, T, 2, 2, H, W))
    for itype in ("float", "int"):
        kw = dict(ws=3, wt=1, ps=3, stride0=1, stride1=1, itype=itype)
        for a, b in zip(nls_gt.nls_search_gt(vid0, vid1, flows, **kw),
                        j_nls.nls_search_gt(vid0, vid1, flows, **kw)):
            np.testing.assert_array_equal(a, b)
        weights = rng.random((B, HD, T, H, W, K))
        offs = 1.7 * rng.standard_normal((B, HD, T, H, W, K, 3))
        offs[..., 0] = rng.integers(-1, 2, offs.shape[:-1])
        np.testing.assert_array_equal(
            agg_gt.gather_stack_gt(vid0, weights, offs, 3, 1, itype=itype),
            j_agg.gather_stack_gt(vid0, weights, offs, 3, 1, itype=itype))


def test_checks_match_jax(rng):
    from stnls_tpu.testing import checks as j_checks
    x = rng.integers(-2, 3, (2, 3, 5, 3)).astype(np.float32)
    x[0, 1, 4] = x[0, 1, 0]
    dups, any_dup = checks.find_duplicate_inds(torch.from_numpy(x))
    j_dups, j_any = j_checks.find_duplicate_inds(x)
    np.testing.assert_array_equal(dups, j_dups)
    assert any_dup == j_any and any_dup
    perm = np.take_along_axis(x, rng.permuted(
        np.broadcast_to(np.arange(5)[:, None], (2, 3, 5, 1)), axis=2), 2)
    assert checks.check_shuffled_inds(torch.from_numpy(x),
                                      torch.from_numpy(perm))
    assert not checks.check_shuffled_inds(x, perm + 1)


def test_gradcheck_on_a_torch_function(rng):
    a = to_torch(rng.standard_normal((3, 4)))
    b = to_torch(rng.standard_normal((4,)))
    assert checks.gradcheck(lambda x, y: (torch.sin(x) * y).sum() ** 2,
                            (a, b), argnums=(0, 1), eps=1e-2)

    class Wrong(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.pow(3).sum()

        @staticmethod
        def backward(ctx, g):
            return torch.ones(3, 4) * g

    with pytest.raises(AssertionError):
        checks.gradcheck(Wrong.apply, (a,), eps=1e-2)


def test_davis_baseball_equals_jax():
    vid = data.davis_baseball(device="cpu")
    ref = stnls_tpu.testing.data.davis_baseball()
    assert vid.shape == (1, 5, 3, 64, 64) and vid.dtype == torch.float32
    np.testing.assert_array_equal(vid.numpy(), np.asarray(ref))
    assert data.load_burst(REPO / "data", "davis_baseball_64x64", 2,
                           device="cpu").shape == (2, 3, 64, 64)


def test_inds_and_mask_match_jax(rng):
    from stnls_tpu.utils import inds as j_inds, mask as j_mask
    vshape = (1, 4, 3, 13, 11)
    assert t_inds.get_batching_info(vshape, 2, 3, 3) == \
        j_inds.get_batching_info(vshape, 2, 3, 3)
    assert t_inds.get_nums_hw(vshape, 2) == j_inds.get_nums_hw(vshape, 2)
    np.testing.assert_array_equal(
        t_inds.get_query_inds(5, 20, 2, 4, 13, 11, device="cpu").numpy(),
        np.asarray(j_inds.get_query_inds(5, 20, 2, 4, 13, 11)))
    offs = np.round(2 * rng.standard_normal((2, 3, 4, 5, 2, 3))) \
        .astype(np.float32)
    m = t_mask.inds_mask(torch.from_numpy(offs), 3, 7, 9, stride0=2)
    ref = j_mask.inds_mask(jnp.asarray(offs), 3, 7, 9, stride0=2)
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(t_mask.mask_to_coords(m),
                                  j_mask.mask_to_coords(ref))


@pytest.mark.parametrize("ndim", [6, 7])
def test_flow2inds_roundtrip_matches_jax(rng, ndim):
    from stnls_tpu.utils import misc as j_misc
    shape = (2, 3, 2, 4, 5, 3, 3)[7 - ndim:]
    flow = (3 * rng.standard_normal(shape)).astype(np.float32)
    got = misc.flow2inds(torch.from_numpy(flow), 2)
    ref = j_misc.flow2inds(jnp.asarray(flow), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    back = misc.inds2flow(got, 2)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        j_misc.inds2flow(ref, 2)))
    np.testing.assert_allclose(back.numpy(), flow, atol=1e-5)
    np.testing.assert_array_equal(
        misc.reflect_inds(got, 4, 5).numpy(),
        np.asarray(j_misc.reflect_inds(ref, 4, 5)))


def test_misc_helpers(tmp_path):
    misc.set_seed(7)
    a = (np.random.rand(), torch.rand(1).item())
    misc.set_seed(7)
    assert a == (np.random.rand(), torch.rand(1).item())
    vid = torch.arange(2 * 3 * 5 * 6.).reshape(2, 3, 5, 6)
    assert misc.rslice(vid, (0, 1, 1, 2, 4, 5)).shape == (1, 3, 3, 3)
    misc.write_pickle(tmp_path / "x.pkl", {"a": 1})
    assert misc.read_pickle(tmp_path / "x.pkl") == {"a": 1}
    misc.assert_nonan(vid)
    grid = misc.get_space_grid(3, 4, device="cpu")
    assert grid.shape == (1, 3, 4, 2) and grid[0, 2, 3].tolist() == [3., 2.]


@pytest.mark.parametrize("mode", ["reflect", "symmetric", "edge", "wrap",
                                  "constant"])
@pytest.mark.parametrize("ps", [3, 9])
def test_same_padded_matches_jnp_pad(rng, mode, ps):
    """6-D input; ps 9 pads 4 > 3, the width of the last dim."""
    vid = rng.standard_normal((1, 2, 2, 3, 5, 3)).astype(np.float32)
    from stnls_tpu.utils import pads as j_pads
    got = pads.same_padded(torch.from_numpy(vid), ps, mode=mode)
    ref = j_pads.same_padded(jnp.asarray(vid), ps, mode=mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert pads.comp_pads(vid.shape, ps, 2, 1) == \
        j_pads.comp_pads(vid.shape, ps, 2, 1)


def test_vid_io_and_viz_inds(rng, tmp_path):
    from stnls_tpu.utils import viz_inds as j_viz
    vid = torch.from_numpy(rng.random((3, 3, 6, 7)).astype(np.float32))
    vid_io.save_video(vid, tmp_path, "v")
    assert torch.equal(vid_io.read_video(tmp_path, "v", device="cpu"), vid)
    vid_io.save_video(vid, tmp_path / "png", "v", itype="png")
    back = vid_io.read_video(tmp_path / "png", "v", itype="png",
                             device="cpu")
    assert back.shape == vid.shape and float((back - vid).abs().max()) < 0.01
    offs = np.round(2 * rng.standard_normal((3, 6, 7, 2, 3)))
    annos = viz_inds.run(vid, torch.from_numpy(offs))
    for a, b in zip(annos, j_viz.run(vid.numpy(), offs)):
        np.testing.assert_array_equal(a, b)
    viz_inds.save_grid(annos, str(tmp_path / "grid.png"))
    assert (tmp_path / "grid.png").exists() or \
        (tmp_path / "grid.png.npy").exists()


# -- debug checks: the first three tests of tests/utils/test_debug_checks.py

@pytest.fixture
def checks_on():
    debug.set_debug_checks(True)
    yield
    debug.set_debug_checks(False)


def test_checks_off_by_default_no_warning():
    assert not debug.debug_checks_enabled()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        debug.emit_count_warning(torch.tensor(5), "should not fire")
        debug.check_finite(torch.tensor([np.nan]), "should not fire")


def test_emit_count_warning_fires(checks_on):
    with pytest.warns(RuntimeWarning, match="out of budget"):
        debug.emit_count_warning(torch.tensor(3, dtype=torch.int32),
                                 "out of budget")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        debug.emit_count_warning(torch.tensor(0), "quiet")


def test_check_finite_and_positive(checks_on):
    with pytest.warns(RuntimeWarning, match="nan in stack"):
        debug.check_finite(torch.tensor([1.0, np.nan]), "nan in stack")
    with pytest.warns(RuntimeWarning, match="counts"):
        debug.check_positive(torch.tensor([1.0, 0.0]), "counts must be > 0")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        debug.check_finite(torch.tensor([1.0, 2.0]), "clean")
        debug.check_positive(torch.tensor([1.0, 2.0]), "clean")


def test_timers_and_memory_on_cpu():
    t = timer.ExpTimer()
    t.sync_start("a")
    t.sync_stop("a")
    assert t["a"] >= 0 and t.names() == ["a"]
    tl = timer.ExpTimerList()
    tl.update_times(t)
    tl.update_times(t)
    assert len(tl["a"]) == 2
    assert mem.bytes_in_use() == 0 and mem.peak_bytes() == 0
    assert mem.reset_peak_gpu_stats() == 0
    assert mem.print_gpu_stats(False) == 0.
    rec = bench.RecordIt()
    for _ in range(2):
        with rec("x"):
            torch.ones(3).sum()
    assert len(rec.timers["x"]) == 2 and rec.mems["x"] == (0., 0.)
    assert set(rec.summary()) == {"times", "mems"}
    assert stnls_tpu_torch.utils.gpu_mem is mem


def test_agg_bench_run_on_cpu(monkeypatch):
    """run() on CPU tensors, at --small's shapes cut to 16^2: each of the
    five aggregators is timed, launches no kernel and reads 0 GB."""
    monkeypatch.setattr(agg_bench, "SMALL", dict(agg_bench.SMALL, H=16,
                                                 W=16))
    res = agg_bench.run(small=True, device="cpu", log=lambda line: None)
    d = res["data"]
    assert tuple(d["menu"]) == agg_bench.NAMES == tuple(d["outs"])
    assert d["outs"]["gather"].shape[-2:] == (16, 16)
    for name in agg_bench.NAMES:
        assert res[name]["launches"] == {"B3": 0, "B7": 0, "B9": 0}
        assert res[name]["ms"] > 0
        assert res[name]["mem_gb"] == res[name]["peak_gb"] == 0.


def test_agg_bench_matches_jax():
    """The twin's inputs and five aggregators at 64^2 (ps 3) against the
    JAX package's on the same numpy inputs. The bench's frame
    offsets round(3 * normal) at T = 3 leave many frames outside the video
    after one reflection. There the port's gathers clamp the frame into
    the video, as B3 does, where the JAX engine clips a flat index over
    all heads: JAX's gathers are given the offsets with their frames so
    clamped. ScatterAdd drops such entries in both packages. Pool reflects
    the frame a second time and drops what is still outside, as B9 does,
    where the JAX engine reads it (a negative frame wraps, one past the end
    gives NaN): JAX's Pool is given those entries with weight 0 and frame
    offset 0."""
    from stnls_tpu_torch.ops.geometry import reflect_bounds
    cfg = dict(agg_bench.SMALL, H=64, W=64)
    p_vid, p_w, p_fl = agg_bench.make_inputs(cfg, "cpu")
    with torch.no_grad():
        outs = {name: agg(p_vid, p_w, p_fl) for name, agg in
                agg_bench.make_menu(cfg["ps"]).items()}
    T = cfg["T"]
    t = torch.arange(T).reshape(1, 1, T, 1, 1, 1)
    nt = reflect_bounds(t + torch.round(p_fl[..., 0]), T)
    beyond = (nt < 0) | (nt > T - 1)
    assert 0.2 < float(beyond.float().mean()) < 0.8
    clamped, kept = p_fl.clone(), p_fl.clone()
    clamped[..., 0] = nt.clamp(0, T - 1) - t
    twice = reflect_bounds(nt, T)
    dropped = (twice < 0) | (twice > T - 1)
    kept[..., 0] = kept[..., 0].masked_fill(dropped, 0.)
    vid, w, w_0, fl, fl_c, fl_k = (jnp.asarray(to_np(x)) for x in (
        p_vid, p_w, p_w.masked_fill(dropped, 0.), p_fl, clamped, kept))
    inputs = dict(gather=(w, fl_c), gather_int=(w, fl_c),
                  gather_add=(w, fl_c), scatter_add=(w, fl), pool=(w_0, fl_k))
    ps = cfg["ps"]
    menu = {"gather": stnls_tpu.agg.NonLocalGather(ps, 1, itype="float"),
            "gather_int": stnls_tpu.agg.NonLocalGather(ps, 1, itype="int"),
            "gather_add": stnls_tpu.agg.NonLocalGatherAdd(ps, 1, 1,
                                                          itype="float"),
            "scatter_add": stnls_tpu.agg.NonLocalScatterAdd(ps, 1, 1,
                                                            itype="int"),
            "pool": stnls_tpu.agg.PooledPatchSum(ps, 1)}
    assert tuple(menu) == agg_bench.NAMES == tuple(outs)
    for name, agg in menu.items():
        assert_close(outs[name], agg(vid, *inputs[name]), name)


# -- the package --

# stnls_tpu modules with no counterpart: the Pallas kernels' files (their
# CUDA kernels are csrc/ with the wrappers ops/*_cuda.py) and the
# alternative XLA engines of functions the port computes otherwise
EXCLUDED = {
    "ops/nls_pallas.py", "ops/nls_pallas_bwd.py", "ops/agg_pallas.py",
    "ops/agg_pallas_bwd.py", "ops/agg_pallas_sp.py",
    "ops/nls_cv.py", "ops/nls_cvr.py", "ops/nls_warp.py",
    "ops/refine_cvr.py",
}


def _modules(pkg):
    root = REPO / pkg
    return {str(p.relative_to(root)) for p in root.rglob("*.py")}


def test_every_module_has_a_counterpart():
    missing = _modules("stnls_tpu") - _modules("stnls_tpu_torch")
    assert missing == EXCLUDED
    for name in stnls_tpu_torch.agg.api.MENU:
        stnls_tpu_torch.agg.api._module(name)


def test_port_imports_no_jax_and_needs_no_optional_packages():
    """In a fresh interpreter where cv2, PIL and matplotlib cannot be
    imported (as on the card's machine), the package and its flow module
    import, and neither JAX nor stnls_tpu gets imported."""
    code = (
        "import sys\n"
        "for name in ('cv2', 'PIL', 'matplotlib', 'jax', 'stnls_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import stnls_tpu_torch\n"
        "from stnls_tpu_torch import flow\n"
        "assert not flow.with_cv\n"
        "assert flow.init_flows((2, 3, 4, 5), device='cpu').fflow.shape == "
        "(2, 2, 4, 5)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    sources = [p for p in (REPO / "stnls_tpu_torch").rglob("*.py")] + \
        [REPO / "chip_smoke.py"]
    for path in sources:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax", "stnls_tpu"), \
                    f"{path}: {line}"
