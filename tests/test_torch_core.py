"""slate_tpu_torch core against the JAX package: TiledMatrix storage and
densification, pad_diag_identity, options, the tune cache and method
routing, the event bus, and the port's independence from JAX.

The same seeded numpy inputs go through both packages on the CPU; the
port is asked for the CPU explicitly (device="cpu")."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slate_tpu as jst
from slate_tpu.core import tiles as jtiles
from slate_tpu.tune import cache as jcache

import slate_tpu_torch as st
from slate_tpu_torch.core import tiles as ttiles
from slate_tpu_torch.core.methods import MethodLUPanel
from slate_tpu_torch.tune import cache as tcache
from slate_tpu_torch.tune import select as tselect

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def tune_env(tmp_path, monkeypatch):
    """Isolated port tune cache."""
    monkeypatch.setenv("SLATE_TPU_TORCH_TUNE_CACHE", str(tmp_path))
    monkeypatch.delenv("SLATE_TPU_TORCH_TUNE", raising=False)
    tcache.reset_cache()
    yield tmp_path
    tcache.reset_cache()


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- TiledMatrix ----------------------------------------------------------

@pytest.mark.parametrize("shape,mb,nb", [((70, 45), 32, 16),
                                         ((64, 64), 32, None),
                                         ((5, 130), 8, 64)])
def test_from_dense_padding_matches_jax(rng, shape, mb, nb):
    # storage is a zero pad to tile multiples: bitwise equal
    a = rng.standard_normal(shape).astype(np.float32)
    J = jtiles.TiledMatrix.from_dense(a, mb, nb)
    T = ttiles.TiledMatrix.from_dense(a, mb, nb, device="cpu")
    assert (T.m, T.n, T.mb, T.nb, T.mt, T.nt) == \
        (J.m, J.n, J.mb, J.nb, J.mt, J.nt)
    assert np.array_equal(_np(T.data), np.asarray(J.data))
    assert np.array_equal(T.to_numpy(), a)


@pytest.mark.parametrize("ctor,args", [
    ("TriangularMatrix", (jst.Uplo.Lower,)),
    ("TriangularMatrix", (jst.Uplo.Upper,)),
    ("SymmetricMatrix", (jst.Uplo.Lower,)),
    ("HermitianMatrix", (jst.Uplo.Upper,)),
])
def test_structured_to_dense_matches_jax(rng, ctor, args):
    # masks, mirrors and transposes move values without arithmetic
    # (the Hermitian mirror subtracts one exact diagonal copy): bitwise
    a = rng.standard_normal((48, 48)).astype(np.float32)
    J = getattr(jst, ctor)(*args, a, mb=16)
    T = getattr(st, ctor)(st.Uplo[args[0].name], a, mb=16, device="cpu")
    assert np.array_equal(T.to_numpy(), np.asarray(J.to_dense()))
    assert np.array_equal(T.T.to_numpy(), np.asarray(J.T.to_dense()))
    assert T.T.resolve().uplo.name == J.T.resolve().uplo.name


def test_unit_triangular_and_transpose_flags(rng):
    a = rng.standard_normal((40, 40)).astype(np.float32)
    J = jst.TriangularMatrix(jst.Uplo.Lower, a, mb=16,
                             diag=jst.Diag.Unit)
    T = st.TriangularMatrix(st.Uplo.Lower, a, mb=16, diag=st.Diag.Unit,
                            device="cpu")
    assert np.array_equal(T.to_numpy(), np.asarray(J.to_dense()))
    assert T.T.op is st.Op.Trans and T.T.T.op is st.Op.NoTrans
    assert T.H.op is st.Op.ConjTrans and T.shape == J.shape


@pytest.mark.parametrize("m,n,mp,np_", [(50, 50, 64, 64), (50, 30, 64, 32),
                                        (64, 64, 64, 64), (10, 60, 16, 64)])
def test_pad_diag_identity_matches_jax(rng, m, n, mp, np_):
    a = np.zeros((mp, np_), np.float32)
    a[:m, :n] = rng.standard_normal((m, n))
    ref = np.asarray(jtiles.pad_diag_identity(jnp.asarray(a), m, n))
    t = torch.as_tensor(a)
    out = ttiles.pad_diag_identity(t, m, n)
    assert np.array_equal(_np(out), ref)
    assert np.array_equal(_np(t), a)            # input never written


def test_zeros_and_tiles(rng):
    Z = st.Matrix(m=20, n=33, mb=8, device="cpu", dtype=torch.float64)
    assert Z.data.shape == (24, 40) and Z.dtype == torch.float64
    a = rng.standard_normal((20, 20)).astype(np.float32)
    T = st.Matrix(a, mb=8, device="cpu")
    assert np.array_equal(_np(T.tile(1, 2)), _np(T.data[8:16, 16:24]))
    assert (T.tileMb(2), T.tileNb(0)) == (4, 8)


# -- devices --------------------------------------------------------------

def test_entry_point_without_device_raises_without_cuda(rng, monkeypatch):
    """No silent CPU fall back: with no card, an entry point given no
    device raises; device="cpu" is the only way onto the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = rng.standard_normal((8, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.Matrix(a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.TiledMatrix.zeros(8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.from_jax_state({"data": a}, {"m": 8, "n": 8, "mb": 8, "nb": 8})
    assert st.Matrix(a, device="cpu").device.type == "cpu"


def test_port_imports_no_jax():
    """The package and chip_smoke.py import neither jax, ml_dtypes nor
    slate_tpu (checked in a fresh interpreter)."""
    code = (
        "import sys, importlib.util\n"
        "import slate_tpu_torch, slate_tpu_torch.testing\n"
        "import slate_tpu_torch.ops.kernels, slate_tpu_torch.ops._build\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        "'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'slate_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_name_no_jax():
    """Lazy imports inside functions do not show in sys.modules: scan
    the sources too, the chip scripts' with them."""
    import ast
    files = [os.path.join(REPO, f) for f in (
        "chip_smoke.py", "chip_compare.py", "chip_gen_band.py",
        "chip_eigh_leaves.py")]
    for root, _, names in os.walk(os.path.join(REPO, "slate_tpu_torch")):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "ml_dtypes",
                                   "slate_tpu"), \
                    (path, mod)


def test_tf32_off_at_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_bf16_reduced_precision_reduction_off_at_import():
    # bf16 products accumulate in f32, as the reference's HIGHEST
    assert torch.backends.cuda.matmul \
        .allow_bf16_reduced_precision_reduction is False


# -- options, tune, methods ----------------------------------------------

def test_options_match_jax():
    from slate_tpu.core import options as jopt
    from slate_tpu_torch.core import options as topt
    assert {k.name: v for k, v in topt._DEFAULTS.items()
            if k is not st.Option.Target} == \
        {k.name: v for k, v in jopt._DEFAULTS.items()
         if k is not jst.Option.Target}
    assert {s: k.name for s, k in topt._STR_ALIASES.items()} == \
        {s: k.name for s, k in jopt._STR_ALIASES.items()}
    opts = {"nb": 96}
    assert topt.get_option(opts, st.Option.BlockSize) == 96
    assert topt.has_option(opts, st.Option.BlockSize)
    assert topt.get_option(None, st.Option.Lookahead) == 1


def test_frozen_table_copied_row_for_row():
    assert tcache.FROZEN == jcache.FROZEN


def test_tune_env_isolated_from_jax(tune_env, monkeypatch, tmp_path):
    """The port reads only its own variables: the JAX cache directory
    and switch do not move it, and vice versa."""
    monkeypatch.setenv("SLATE_TPU_TUNE_CACHE", str(tmp_path / "jax"))
    monkeypatch.setenv("SLATE_TPU_TUNE", "0")
    assert tcache.cache_dir() == str(tune_env)
    assert tcache.enabled()
    assert jcache.cache_dir() == str(tmp_path / "jax")
    monkeypatch.setenv("SLATE_TPU_TORCH_TUNE", "0")
    assert not tcache.enabled()


def test_tune_cache_put_save_resolve(tune_env):
    assert tcache._backend_device() == ("cpu", "cpu")
    assert tcache.make_key("lu_panel", torch.float32, 300) == \
        "lu_panel|cpu|cpu|float32|512"
    assert tcache.make_key("lu_panel", np.float32, 300) == \
        tcache.make_key("lu_panel", torch.float32, 300)
    c = tcache.get_cache()
    c.put("lu_panel", torch.float32, 512,
          {"method_lu_panel": "pallas_rec"})
    path = c.save()
    tcache.reset_cache()
    assert tcache.TuneCache._parse(path)
    assert MethodLUPanel.resolve(512, 128, torch.float32) \
        is MethodLUPanel.PallasRec
    # other buckets and dtypes stay cold
    assert MethodLUPanel.resolve(2048, 128, torch.float32) \
        is MethodLUPanel.Native
    assert MethodLUPanel.resolve(512, 128, torch.bfloat16) \
        is MethodLUPanel.Fori
    with tselect.disabled():
        assert MethodLUPanel.resolve(512, 128, torch.float32) \
            is MethodLUPanel.Native
    # explicit options beat the cache; frozen rows serve the rest
    c.put("getrf", torch.float32, 512, {"nb": 64})
    assert tselect.tuned_int("getrf", "nb", 256, n=512,
                             dtype=torch.float32) == 64
    assert tselect.tuned_int("getrf", "nb", 256, opts={"nb": 32},
                             option=st.Option.BlockSize, n=512) == 32
    assert tselect.resolve("lu_panel", "ib") == 32


def test_corrupt_cache_is_empty(tune_env):
    with open(tcache.cache_path(), "w") as f:
        f.write("{not json")
    tcache.reset_cache()
    assert tcache.get_cache().lookup("lu_panel", torch.float32, 512) is None


@pytest.mark.parametrize("m,w,dtype", [(256, 64, "float32"),
                                       (256, 64, "bfloat16"),
                                       (256, 64, "float64")])
def test_cold_panel_route_matches_jax(tune_env, m, w, dtype):
    """A cold cache routes as the reference does on the CPU: native
    where the library LU takes the dtype, else the fori loop."""
    from slate_tpu.core.methods import MethodLUPanel as JMethod
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    assert MethodLUPanel.cold_default(m, w, tdt).name == \
        JMethod.cold_default(m, w, jdt).name


# -- obs ------------------------------------------------------------------

def test_instrumented_driver_publishes_when_enabled(rng):
    from slate_tpu_torch.obs import events as ev
    from slate_tpu_torch.testing import permuted_boosted_system
    a, b = permuted_boosted_system(rng, 64, 2)
    A = st.Matrix(a, mb=32, device="cpu")
    B = st.Matrix(b, mb=32, device="cpu")
    ev.clear()
    st.gesv(A, B)
    assert ev.events() == []                   # off by default
    ev.enable()
    try:
        tm = st.Timers()
        st.gesv(A, B, {st.Option.Timers: tm})
        names = [e.name for e in ev.events(cat="driver")]
        assert names.count("gesv") == 1 and names.count("getrf") == 1
        assert {"gesv::getrf", "gesv::getrs"} <= set(tm.values)
    finally:
        ev.disable()
        ev.clear()


# -- the names ported modules used to leave out ---------------------------

#: names dir(slate_tpu) has and dir(slate_tpu_torch) still lacks, with
#: the ROADMAP queue 1 item that brings each
STILL_MISSING = {
    "smap": "never (a JAX-version shim of shard_map)",
    "testing": "item 12 (the port's testing package holds its chip "
               "helpers and the multi-process launcher)",
    "c_api": "item 12",
    # JAX-only: they probe JAX's backend; the port takes a device
    "force_cpu": "never (JAX-only)", "probe_backend": "never (JAX-only)",
}


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_top_level_names_match_reference():
    """Everything the reference exports from its top level is exported
    by the port, except STILL_MISSING (each with its item)."""
    import slate_tpu.utils.backend as jbackend
    from slate_tpu_torch.utils import backend as tbackend
    missing = _public(jst) - _public(st)
    assert missing <= set(STILL_MISSING), sorted(missing - set(
        STILL_MISSING))
    assert _public(jbackend) - _public(tbackend) - {
        "json", "os", "subprocess", "sys"} <= set(STILL_MISSING)
    for name in ("Deflation", "OptionError", "Target", "get_option",
                 "normalize_options", "str2method", "slate_assert",
                 "slate_error_if", "ceil_div", "round_up", "Layout",
                 "TileKind", "MethodTrsm", "MethodGemm", "MethodHemm",
                 "serve", "parallel", "dist", "make_grid", "ProcessGrid",
                 "single_device_grid", "distribute_cyclic"):
        assert hasattr(st, name), name
    # the port's own testing package binds its name once imported
    for name in set(STILL_MISSING) - {"testing"}:
        assert not hasattr(st, name), name


def test_enums_and_exceptions_match_reference():
    for name in ("Layout", "TileKind", "Target"):
        assert {m.name: m.value for m in getattr(st, name)} == \
            {m.name: m.value for m in getattr(jst, name)}
    st.slate_error_if(False, "never")
    with pytest.raises(st.SlateError, match="boom"):
        st.slate_error_if(True, "boom")
    with pytest.raises(st.SlateError, match="error condition"):
        st.slate_error_if(True)


def test_normalize_options_matches_reference():
    from slate_tpu.core import options as jopt
    opts = {"nb": 64, "IB": 8, st.Option.Lookahead: 2,
            "method_gemm": "A"}
    jopts = {"nb": 64, "IB": 8, jst.Option.Lookahead: 2,
             "method_gemm": "A"}
    got = st.normalize_options(opts)
    assert {k.name: v for k, v in got.items()} == \
        {k.name: v for k, v in jopt.normalize_options(jopts).items()}
    assert st.normalize_options(None) == {}
    for bad in ({"no_such_option": 1}, {3: 1}):
        with pytest.raises(KeyError):
            st.normalize_options(bad)
        with pytest.raises(KeyError):
            jopt.normalize_options(bad)


#: str2method families the port still lacks, with their item (none)
FAMILIES_MISSING = {}


def test_str2method_every_family_matches_reference():
    from slate_tpu.core import methods as jm
    fams = ("trsm", "gemm", "hemm", "cholqr", "gels", "lu", "factor",
            "eig", "svd", "lu_panel", "ooc", "lu_pivot", "precision",
            "batch", "scheduler", "ownership", "visit_fuse")
    for fam in fams:
        jfam = type(jm.str2method(fam, "auto"))
        if fam in FAMILIES_MISSING:
            with pytest.raises(KeyError):
                st.str2method(fam, "auto")
            continue
        for mem in jfam:
            for s in (mem.value, mem.name, mem.name.upper()):
                got = st.str2method(fam, s)
                assert (type(got).__name__, got.name, got.value) == \
                    (jfam.__name__, mem.name, mem.value), (fam, s)
        with pytest.raises(KeyError):
            st.str2method(fam, "no-such-method")


def test_method_selects_match_reference():
    from slate_tpu.core import methods as jm
    sizes = (1, 8, 64, 255, 256, 257, 1024, 4096)
    for left in (True, False):
        for a_n in sizes:
            for b_m in sizes:
                for b_n in sizes:
                    assert st.MethodTrsm.select(left, a_n, b_m, b_n).name \
                        == jm.MethodTrsm.select(left, a_n, b_m, b_n).name
    for m in sizes:
        for n in sizes:
            assert st.MethodHemm.select(m, n).name == \
                jm.MethodHemm.select(m, n).name
            for k in sizes:
                assert st.MethodGemm.select(m, n, k).name == \
                    jm.MethodGemm.select(m, n, k).name


def _gemm_operands(rng):
    a = rng.standard_normal((40, 24))
    b = rng.standard_normal((24, 32))
    c = rng.standard_normal((40, 32))
    return a, b, c


@pytest.mark.parametrize("method", ["Auto", "A", "C"])
def test_gemm_methods_run_the_one_device_product(rng, method):
    a, b, c = _gemm_operands(rng)
    T = [st.Matrix(x, mb=16, device="cpu") for x in (a, b, c)]
    J = [jst.Matrix(x, mb=16) for x in (a, b, c)]
    got = st.gemm(1.5, T[0], T[1], -0.5, T[2],
                  {st.Option.MethodGemm: getattr(st.MethodGemm, method)})
    ref = jst.gemm(1.5, J[0], J[1], -0.5, J[2],
                   {jst.Option.MethodGemm: getattr(jst.MethodGemm,
                                                   method)})
    np.testing.assert_allclose(got.to_numpy(), np.asarray(ref.to_dense()),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("call", ["gemm", "gemmA", "gemmC", "trsm",
                                  "trsmA", "trsmB", "summa"])
def test_grid_and_summa_raise(rng, call):
    """gemm, gemmA, gemmC and the trsm family take Option.Grid only as a
    parallel.ProcessGrid and raise on anything else (the grid routes
    themselves: tests/test_torch_grid.py); MethodGemm.Summa without a
    grid is the one-device product, as the reference's."""
    a, b, c = _gemm_operands(rng)
    A, B, C = (st.Matrix(x, mb=16, device="cpu") for x in (a, b, c))
    grid = {st.Option.Grid: object()}
    if call == "summa":
        got = st.gemm(1.0, A, B, 0.0, C,
                      {st.Option.MethodGemm: st.MethodGemm.Summa})
        J = [jst.Matrix(x, mb=16) for x in (a, b, c)]
        ref = jst.gemm(1.0, J[0], J[1], 0.0, J[2],
                       {jst.Option.MethodGemm: jst.MethodGemm.Summa})
        np.testing.assert_allclose(got.to_numpy(),
                                   np.asarray(ref.to_dense()),
                                   rtol=1e-10, atol=1e-12)
        return
    with pytest.raises(TypeError, match="ProcessGrid"):
        if call.startswith("gemm"):
            getattr(st, call)(1.0, A, B, 0.0, C, grid)
        else:
            L = st.TriangularMatrix(st.Uplo.Lower,
                                    np.tril(a[:24, :24]) + 24 * np.eye(24),
                                    mb=16, device="cpu")
            getattr(st, call)(st.Side.Left, 1.0, L,
                              st.Matrix(b, mb=16, device="cpu"), grid)


def test_trace_svg_matches_reference():
    """on / block / mark / finish over the bus: the SVG has the
    reference's element count for the same spans, and finish clears
    only the trace's categories."""
    from slate_tpu.obs import events as jev
    from slate_tpu.utils import trace as jtrace
    from slate_tpu_torch.obs import events as tev
    from slate_tpu_torch.utils import trace as ttrace
    svgs = []
    for tr, ev in ((ttrace, tev), (jtrace, jev)):
        ev.clear()
        tr.on()
        try:
            with tr.block("outer"):
                with tr.block("inner <&>"):
                    pass
                tr.mark("tune::decision")
            with tr.block("outer"):
                pass
            ev.instant("driver::keep", cat="driver")
            svgs.append(tr.finish())
            assert [e.name for e in ev.events()] == ["driver::keep"]
            assert tr.finish() is None
        finally:
            tr.off()
            ev.clear()
    port, ref = svgs
    for tag in ("<svg", "<text", "<rect", "<title>", "</svg>"):
        assert port.count(tag) == ref.count(tag), tag
    assert "inner &lt;&amp;&gt;" in port
