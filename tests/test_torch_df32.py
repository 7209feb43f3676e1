"""The port's double-single arithmetic (tuun_tpu_torch/engine/df32.py).

Twins of tests/test_df32.py on the port's df32; each elementwise op
against tuun_tpu's on the same inputs; and the compensated prefix sum's
plain version (scan_ops.df_prefix_sum_ref, a doubling scan) against
tuun_tpu's df_cumsum and the float64 cumsum, single and over rows."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuun_tpu.engine import df32 as jdf32
from tuun_tpu_torch.engine import df32, kernels, scan_ops

torch.set_num_threads(1)


def t(x):
    return torch.from_numpy(np.asarray(x))


# -- twins of test_df32.py ---------------------------------------------------


def test_two_sum_is_error_free():
    rng = np.random.default_rng(0)
    a = rng.uniform(-1e6, 1e6, 4096).astype(np.float32)
    b = rng.uniform(-1e-3, 1e-3, 4096).astype(np.float32)
    s, err = df32.two_sum(t(a), t(b))
    got = s.numpy().astype(np.float64) + err.numpy().astype(np.float64)
    assert np.array_equal(got, a.astype(np.float64) + b.astype(np.float64))


def test_two_prod_is_error_free():
    rng = np.random.default_rng(1)
    a = rng.uniform(-1e3, 1e3, 4096).astype(np.float32)
    b = rng.uniform(-1e3, 1e3, 4096).astype(np.float32)
    p, err = df32.two_prod(t(a), t(b))
    got = p.numpy().astype(np.float64) + err.numpy().astype(np.float64)
    assert np.array_equal(got, a.astype(np.float64) * b.astype(np.float64))


def test_df_cumsum_holds_f64_accuracy_where_f32_drifts():
    rng = np.random.default_rng(2)
    inc = (0.1727 + 0.01 * rng.standard_normal(1 << 18)).astype(np.float32)
    ref = np.cumsum(inc.astype(np.float64))
    plain = torch.cumsum(t(inc), 0).numpy().astype(np.float64)
    h, l = df32.df_cumsum(t(inc))
    comp = df32.df_to_f64(h, l)
    err_plain = np.abs(plain - ref).max()
    err_comp = np.abs(comp - ref).max()
    assert err_comp < 1e-4
    assert err_comp < err_plain / 1e3
    assert err_plain > 1e-3


def test_df_mod_tau_and_sin_match_f64():
    rng = np.random.default_rng(3)
    phases64 = rng.uniform(0, 5e4, 2048)
    h64 = phases64.astype(np.float32)
    l64 = (phases64 - h64.astype(np.float64)).astype(np.float32)
    mh, ml = df32.df_mod_tau(t(h64), t(l64))
    red = df32.df_to_f64(mh, ml)
    d = np.abs(red - np.mod(phases64, 2 * math.pi))
    d = np.minimum(d, 2 * math.pi - d)
    assert d.max() < 1e-5
    got = df32.df_sin(mh, ml).numpy().astype(np.float64)
    assert np.abs(got - np.sin(phases64)).max() < 2e-6


def test_df_mul_accuracy():
    rng = np.random.default_rng(4)
    x = rng.uniform(-100, 100, 1024)
    y = rng.uniform(-100, 100, 1024)
    xh, xl = df32.df_from_f64(x)
    yh, yl = df32.df_from_f64(y)
    ph, pl = df32.df_mul(xh, xl, yh, yl)
    got = df32.df_to_f64(ph, pl)
    rel = np.abs(got - x * y) / np.maximum(np.abs(x * y), 1e-30)
    assert rel.max() < 1e-13


# -- each op against tuun_tpu's ----------------------------------------------


def _pair(rng, n, lo, hi):
    x = rng.uniform(lo, hi, n)
    h = x.astype(np.float32)
    return h, (x - h.astype(np.float64)).astype(np.float32)


def _op_inputs():
    rng = np.random.default_rng(5)
    n = 1 << 14
    a = rng.uniform(-1e4, 1e4, n).astype(np.float32)
    b = rng.uniform(-1e2, 1e2, n).astype(np.float32)
    xh, xl = _pair(rng, n, -1e3, 1e3)
    yh, yl = _pair(rng, n, -1e3, 1e3)
    ph, pl = _pair(rng, n, 0, 5e4)
    return {"two_sum": (a, b), "fast_two_sum": (a, b), "split": (a,),
            "two_prod": (a, b), "df_add": (xh, xl, yh, yl),
            "df_mul": (xh, xl, yh, yl), "df_div_f32": (a, b),
            "df_mod_tau": (ph, pl), "df_sin": (ph, pl)}


@pytest.mark.parametrize("name", sorted(_op_inputs()))
def test_op_matches_tuun_tpu(name):
    """The same bits as tuun_tpu's op on the same inputs: neither XLA's
    CPU backend nor eager torch contracts a product into a fused
    multiply-add here.  df_sin alone differs, by at most 1 ulp: torch's
    and XLA's sin and cos are other implementations."""
    args = _op_inputs()[name]
    want = getattr(jdf32, name)(*[jnp.asarray(x) for x in args])
    got = getattr(df32, name)(*[t(x) for x in args])
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype == np.float32
        if name == "df_sin":
            ulp = np.spacing(np.abs(w).astype(np.float32))
            assert np.all(np.abs(g.astype(np.float64) - w) <= ulp)
        else:
            assert np.array_equal(g.view(np.int32), w.view(np.int32))


# -- the compensated prefix sum's plain version ------------------------------


def _fm_increments(rng, shape):
    """FM phase increments as exact_df makes them: df_div_f32 of 2 pi
    (220 + 55 sin(0.001 i + phase)) by 44100."""
    n = shape[-1]
    phase = rng.uniform(0, 6, shape[:-1] + (1,))
    f = (2 * np.pi * (220 + 55 * np.sin(0.001 * np.arange(n) + phase))
         ).astype(np.float32)
    return df32.df_div_f32(t(f), torch.tensor(44100.0))


@pytest.mark.parametrize("n", [1, 5, 1000, 1 << 18])
def test_df_prefix_sum_ref_against_jax_and_f64(n):
    """The doubling scan and tuun_tpu's df_cumsum (an associative_scan,
    another grouping) both within test_df32.py's bounds of the float64
    cumsum: < 1e-4 rad, and at the longest 10^3 below the f32 cumsum's
    drift."""
    xh, xl = _fm_increments(np.random.default_rng(6), (n,))
    ref = np.cumsum(xh.numpy().astype(np.float64)
                    + xl.numpy().astype(np.float64))
    h, l = scan_ops.df_prefix_sum_ref(xh, xl)
    jh, jl = jdf32.df_cumsum(jnp.asarray(xh.numpy()), jnp.asarray(xl.numpy()))
    err = np.abs(df32.df_to_f64(h, l) - ref).max()
    jerr = np.abs(jdf32.df_to_f64(jh, jl) - ref).max()
    f32 = np.abs(np.cumsum(xh.numpy()).astype(np.float64) - ref).max()
    assert err < 1e-4 and jerr < 1e-4
    if n == 1 << 18:
        assert err < f32 / 1e3 and f32 > 1e-3
    # Both f64-class: within 2^-40 of sum |x|, as chip_smoke.py holds
    # the kernel.
    bound = 2.0 ** -40 * np.abs(ref[-1])
    assert err <= bound and jerr <= bound


def test_df_prefix_sum_rows_are_single_rows():
    """The rows form's plain version: each row the bits of a single call
    on it, within the float64 bound."""
    xh, xl = _fm_increments(np.random.default_rng(7), (5, 3000))
    h, l = scan_ops.df_prefix_sum_rows_f32(xh, xl)
    for r in range(5):
        sh, sl = scan_ops.df_prefix_sum_f32(xh[r].contiguous(),
                                            xl[r].contiguous())
        assert torch.equal(sh.view(torch.int32), h[r].view(torch.int32))
        assert torch.equal(sl.view(torch.int32), l[r].view(torch.int32))
        ref = np.cumsum(xh[r].double().numpy() + xl[r].double().numpy())
        assert np.abs(df32.df_to_f64(sh, sl) - ref).max() \
            <= 2.0 ** -40 * ref[-1]


def test_df_cumsum_under_vmap_takes_the_rows_form():
    """df_cumsum on batched tensors (a voice group's render) reaches the
    rows form through the custom op's batching rule, with no warning of a
    loop over voices, and gives each row's single-call bits."""
    import warnings
    xh, xl = _fm_increments(np.random.default_rng(8), (4, 700))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        h, l = torch.func.vmap(df32.df_cumsum)(xh, xl)
    want = scan_ops.df_prefix_sum_rows_f32(xh, xl)
    assert torch.equal(h, want[0]) and torch.equal(l, want[1])


def test_wrappers_check_their_inputs():
    x = torch.zeros(8)
    with pytest.raises(ValueError):
        scan_ops.df_prefix_sum_f32(x, torch.zeros(7))
    with pytest.raises(ValueError):
        scan_ops.df_prefix_sum_f32(x.double(), x.double())
    with pytest.raises(ValueError):
        scan_ops.df_prefix_sum_rows_f32(x, x)


# -- the library and the df prefix sum's scratch -----------------------------


def test_build_libraries_runs_one_nvcc_per_source(monkeypatch, tmp_path):
    """The kernel sources build at once, each into a library of its own
    keyed by its hash: csrc/scan.cu and csrc/lanes.cu by one nvcc each,
    csrc/exact.cu by one a part (TUUN_EXACT_PART 1-3, objects compiled at
    once) and a link; a second call finds them all built."""
    import types
    calls = []
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")

    def run(argv, **kw):
        calls.append(argv)
        (tmp_path / argv[argv.index("-o") + 1]).write_bytes(b"so")
        return types.SimpleNamespace(returncode=0, stderr="")
    monkeypatch.setattr(kernels.subprocess, "run", run)
    libs = kernels.build_libraries()
    assert sorted(p.name.split("_")[1] for p in libs) == ["exact", "lanes",
                                                          "scan"]
    scan = [c for c in calls if c[-1] == str(kernels.SOURCE)]
    lanes = [c for c in calls if c[-1] == str(kernels.LANES_SOURCE)]
    parts = [c for c in calls if c[-1] == str(kernels.EXACT_SOURCE)]
    links = [c for c in calls if c[-1].endswith(".o")]
    assert len(scan) == 1 and "-shared" in scan[0]
    assert len(lanes) == 1 and "-shared" in lanes[0]
    assert sorted(next(a for a in c if a.startswith("-DTUUN_EXACT_PART="))
                  for c in parts) == ["-DTUUN_EXACT_PART=1",
                                      "-DTUUN_EXACT_PART=2",
                                      "-DTUUN_EXACT_PART=3"]
    assert all("-c" in c and "-shared" not in c for c in parts)
    assert len(links) == 1 and "-shared" in links[0]
    assert sorted(links[0][-3:]) == sorted(c[c.index("-o") + 1]
                                           for c in parts)
    assert len(calls) == 6
    assert kernels.build_libraries() == libs and len(calls) == 6


def test_df_scratch_grows_keeps_the_old_and_is_released(monkeypatch):
    """The df prefix sum's scratch follows the affine scan's rule: made
    at DF_SCRATCH_MIN_LANES' tiles, a longer scan gets a buffer of twice
    the capacity and the old one is kept; inside a graph_scope a scan
    takes its owner's buffer, freed with release_scratch."""
    monkeypatch.setattr(scan_ops, "_df_scratch", {})
    monkeypatch.setattr(scan_ops, "_affine_retired", [])
    monkeypatch.setattr(scan_ops, "_df_tile", 2048)
    made = []

    def alloc(device, cap):
        made.append((device, cap))
        return object()
    first = -(-scan_ops.DF_SCRATCH_MIN_LANES // 2048)
    buf, cap = scan_ops.df_scratch(0, 7, 3, alloc)
    assert cap == first and scan_ops.df_scratch(0, 7, first, alloc)[0] is buf
    buf2, cap2 = scan_ops.df_scratch(0, 7, first + 1, alloc)
    assert cap2 == 2 * first and scan_ops._affine_retired == [buf]
    owner = object()
    with kernels.graph_scope(owner):
        own, _ = scan_ops.df_scratch(0, 7, 3, alloc)
    assert own is not buf2 and (0, 7, owner) in scan_ops._df_scratch
    scan_ops.release_scratch(owner)
    assert (0, 7, owner) not in scan_ops._df_scratch
    assert made == [(0, first), (0, 2 * first), (0, first)]


def test_exact_kernels_round_each_op_on_its_own():
    """csrc/exact.cu writes the recurrence's products and differences and
    df_add's sums as intrinsics that round on their own (nvcc would
    contract a*b+c into a fused multiply-add), and its C entry points
    match scan_ops' bindings."""
    src = kernels.EXACT_SOURCE.read_text()
    for intrinsic in ("__fmul_rn", "__fsub_rn", "__dmul_rn", "__dsub_rn",
                      "__fadd_rn"):
        assert intrinsic in src
    import re
    def body(fn):
        return re.search(rf"\b{fn}\(.*?\n}}\n", src, re.S).group(0)
    for fn in ("rec_group", "rec_chain_stage"):
        assert "sub_rn(acc, mul_rn(" in body(fn)
    # The wide form: the first product on the chain, a[1] h[1] a lane
    # ahead, the later products two lanes ahead, each rounded on its own.
    wide = body("rec_wide_lane")
    assert "acc = sub_rn(r.ff, mul_rn(r.a0, h0r));" in wide
    assert "acc = sub_rn(acc, r.p1);" in wide
    assert "r.p1 = mul_rn(a11, h0r);" in wide
    assert "mul_rn(in.v[s], in.h[s]);" in body("rec_wide_put")
    run = body("rec_wide_run")
    assert "acc = sub_rn(acc, q[c % 4][k]);" in run
    assert "acc = sub_rn(acc, z[k]);" in run
    # The streamed form: the same chain, lane x + 1's products formed
    # during lane x's, each rounded on its own.
    lane = body("rec_stream_lane")
    assert "acc = sub_rn(r.ff, mul_rn(r.a0, h0r));" in lane
    assert "acc = sub_rn(acc, r.p1);" in lane
    assert "r.p1 = mul_rn(a11, h0r);" in lane
    assert "Pn[j - 2] = mul_rn(av, hv);" in body("rec_stream_slot")
    assert "acc = sub_rn(acc, q[c % 4][k]);" in body("rec_stream_chunks")
    # df_add's every op an intrinsic, as the df kernel folds with it.
    add = body("df_add")
    assert add.count("__fadd_rn(") == 5 and add.count("__fsub_rn(") == 6
    assert "df_add(" in body("df_prefix_sum")
    for fn in ("rec_group", "rec_chain_stage", "rec_wide_lane",
               "rec_wide_run", "rec_stream_lane", "rec_stream_slot",
               "rec_stream_chunks", "df_add", "df_prefix_sum",
               "df_look_back"):
        assert not re.search(r"(acc|\.h|\.l)\s*[-+]=|acc\s*=\s*acc\s*[-+]"
                             r"|[^_]\b\w+\.[hl]\s*[-+*]\s*\w", body(fn)), fn
    for name in ("tuun_linear_recurrence_rows_f32",
                 "tuun_linear_recurrence_rows_f64",
                 "tuun_df_prefix_sum_rows_f32", "tuun_df_scratch_words",
                 "tuun_df_tile", "tuun_recurrence_max_j",
                 "tuun_df_resident"):
        assert re.search(rf"\b{name}\(", src)
    assert f"kRecMaxJ = {scan_ops.MAX_RECURRENCE_J};" in src


# -- the df kernel's grouping (chip_smoke.df_model) --------------------------


def _smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_df_tests",
        Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_df_model_has_the_kernels_geometry():
    """chip_smoke's model of the df kernel takes exact.cu's tiles: its
    DF_GEOMETRY is the source's constants and launches, an anchor every
    `threads` tiles."""
    import re
    cs = _smoke()
    src = kernels.EXACT_SOURCE.read_text()

    def const(name):
        return eval(re.search(rf"constexpr \w+ {name} = ([^;]+);",
                              src).group(1))
    assert const("kDfOneTile") == cs.DF_GEOMETRY[0][0]
    assert "const bool anchor = t % kThreads == 0;" in src
    assert "(t - 1) / kThreads * kThreads;" in src
    launches = re.findall(r"return launch_df<(\d+), (\d+), \w+>", src)
    assert {(int(a), int(b)) for a, b in launches} == \
        {g[1:] for g in cs.DF_GEOMETRY}
    assert [const(k) for k in ("kDfOneTile", "kDfWideTile", "kDfTile",
                               "kDfWideTile")] == \
        [a * b for _, a, b in cs.DF_GEOMETRY]
    assert (const("kDfWideTile"), const("kDfTileMax")) == \
        tuple(g[0] for g in cs.DF_GEOMETRY[1:3])


def test_df_sum_counts_every_multi_tile_grid():
    """Every grid whose rows have more than one tile takes its tiles from
    the tile counter, whatever the card holds at once; a one-tile row's
    block is its tile.  The rule, read from exact.cu as the constants
    are, is "more than one tile a row", and the launch no longer asks
    how many blocks the card holds."""
    import re
    src = kernels.EXACT_SOURCE.read_text()
    rule = re.search(r"constexpr bool df_counted\(int64_t (\w+)\) \{\s*"
                     r"return ([^;]+);", src)
    arg, expr = rule.groups()
    assert [eval(expr, {arg: k}) for k in range(4)] == \
        [False, False, True, True]
    kernel = re.search(r"\bdf_prefix_sum\(.*?\n}\n", src, re.S).group(0)
    assert "const int64_t nbr = (n + kTile - 1) / kTile;  // tiles per row" \
        in kernel
    assert "const bool counted = df_counted(nbr);" in kernel
    # While the counter answers, the block sends tile blockIdx.x towards
    # L2; it stages the tile it drew.
    counter = kernel.index("drawn = atomicAdd(&scratch[kDfTicket], 1u);")
    ahead = kernel.index("df_prefetch_tile<kThreads, kTile>(xh_all, xl_all, "
                         "n, nbr, gt);")
    drawn = kernel.index("gt = taken;")
    staged = kernel.index("df_stage_tile<kThreads, kTile>(xh_all, xl_all, "
                          "n, nbr, gt, stage_h,")
    assert kernel.index("int64_t gt = blockIdx.x;") < counter < ahead \
        < drawn < staged
    # The counter has a 128-byte line of its own, between the done counter
    # (word 0) and the flags (from kDfHead).
    words = {k: eval(re.search(rf"constexpr int {k} = ([^;]+);", src).group(1))
             for k in ("kDfTicket", "kDfHead")}
    assert words["kDfTicket"] * 4 >= 128
    assert (words["kDfHead"] - words["kDfTicket"]) * 4 >= 128
    assert "scratch[0] = scratch[kDfTicket] = 0;" in kernel
    launch = re.search(r"int launch_df\(.*?\n}\n", src, re.S).group(0)
    assert "resident" not in launch and "counted" not in launch
    assert "cap, rows, n);" in launch


@pytest.mark.parametrize("n", [1 << 10, (1 << 12) + 3, 1 << 14, 1 << 17,
                               1 << 20])
def test_df_model_holds_the_f64_bound(n):
    """The kernel's grouping in numpy float32 at chip_smoke's DF_SIZES:
    within DF_REL_TOL of sum |x| of the float64 cumsum, as phase 11 holds
    the kernel, and 10^3 below the f32 cumsum's drift at 2^17 and up."""
    cs = _smoke()
    assert n in cs.DF_SIZES
    xh, xl = (x.numpy() for x in _fm_increments(np.random.default_rng(8),
                                                 (n,)))
    oh, ol = cs.df_model(np, xh, xl)
    x = xh.astype(np.float64) + xl.astype(np.float64)
    ref = np.cumsum(x)
    err = np.abs(oh.astype(np.float64) + ol.astype(np.float64) - ref).max()
    assert err <= cs.DF_REL_TOL * np.abs(x).sum()
    if n >= 1 << 17:
        f32 = np.abs(np.cumsum(xh).astype(np.float64) - ref).max()
        assert err < f32 / 1e3


@pytest.mark.parametrize("n", [97, 1024, 1500, 4096 + 3, (1 << 18) + 3])
def test_df_model_rows_are_single_rows(n):
    """A row of a rows call has a one-row call's bits: the grouping is a
    function of the lane's place in its row alone (one tile, one staged
    tile, tiles with a look-back)."""
    cs = _smoke()
    xh, xl = (x.numpy() for x in _fm_increments(np.random.default_rng(9),
                                                 (3, n)))
    oh, ol = cs.df_model(np, xh, xl)
    for r in range(3):
        sh, sl = cs.df_model(np, xh[r], xl[r])
        assert np.array_equal(sh.view(np.int32), oh[r].view(np.int32))
        assert np.array_equal(sl.view(np.int32), ol[r].view(np.int32))
