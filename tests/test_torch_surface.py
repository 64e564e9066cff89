"""The port's public surface against the JAX package's, and the last names
it gained, each held against JAX on the same numpy-seeded inputs.

The surface: for every module of ``qgemm_tpu/`` (read with ``ast``: its
functions, classes, constants, and in a package's ``__init__`` the names it
imports), each public name has a counterpart in the port (found with
``importlib``), each public function's and method's parameters are among
its counterpart's (``inspect.signature``; a class's methods and attributes
count through its bases), and each field or property of a class is an
attribute of its counterpart. ``MODULES`` and ``RENAMED`` map the Pallas
modules and entry points to the port's; ``DIFFERENCES`` is the one list of
deliberate differences, each with its reason.

Tolerances: ``layernorm`` 1e-5 (f32, reductions in another order);
``dequantize_weights_int4`` bit for bit (the same f32 operations, then one
round to the dtype); the matmuls as tests/test_torch_quantize.py (rtol and
atol 1e-6) and tests/test_torch_outlier.py (1e-6 of the largest output);
the float64 error metrics 1e-12; ``flops_per_sec`` and ``__version__``
exactly.
"""

import ast
import fnmatch
import importlib
import inspect
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qgemm_tpu
import qgemm_tpu_torch
from qgemm_tpu.ops import quantize as jq
from qgemm_tpu.utils import profiling as jprof
from qgemm_tpu.utils import testing as jtest
from qgemm_tpu_torch.ops import quantize as tq
from qgemm_tpu_torch.utils import profiling as tprof
from qgemm_tpu_torch.utils import testing as ttest
from qgemm_tpu_torch.utils.testing import assert_allclose, use_test_threads

use_test_threads()

# the ops packages' attribute ``layernorm`` is the function
jln = importlib.import_module("qgemm_tpu.ops.layernorm")
tln = importlib.import_module("qgemm_tpu_torch.ops.layernorm")

JAX_ROOT = Path(qgemm_tpu.__file__).parent

# A JAX module whose names the port keeps in other modules -> those modules
# (relative to each package); every other module maps to its own path,
# ops/pallas/ read as ops/cuda/.
MODULES = {
    "ops/pallas/quantized_matmul": ("ops/cuda/quantized_matmul", "ops/cuda/col_quantize",
                                    "ops/quantize"),
    "ops/pallas/w4a8_matmul": ("ops/cuda/w4a8_matmul", "ops/quantize"),
    "ops/pallas/paged_attention": ("ops/cuda/paged_decode_attention",
                                   "ops/cuda/paged_context_attention", "ops/quantize"),
}

# A Pallas entry point -> the port's function that launches its kernel (a
# class's __call__ is its counterpart's forward, by nn.Module's rule).
RENAMED = {
    "ops/pallas/quantized_matmul.quantized_matmul_pallas": "ops/quantize.quantized_matmul",
    "ops/pallas/quantized_matmul.quantized_matmul_prequant_pallas":
        "ops/quantize.quantized_matmul_prequant",
    "ops/pallas/quantized_matmul.col_quantize_pallas": "ops/cuda/col_quantize.col_quantize",
    "ops/pallas/w4a8_matmul.w4a8_matmul_pallas": "ops/quantize.quantized_matmul_prequant_w4",
    "ops/pallas/expert_matmul.grouped_quantized_matmul_pallas":
        "ops/cuda/expert_matmul.grouped_quantized_matmul",
    "ops/pallas/expert_matmul.quantized_expert_ffn_pallas":
        "ops/cuda/expert_matmul.quantized_expert_ffn_kernel",
    "ops/pallas/softmax.softmax_pallas": "ops/cuda/softmax.softmax",
    "ops/pallas/layernorm.layernorm_residual_pallas": "ops/cuda/layernorm.layernorm_residual",
}

# The deliberate differences, and no others: (JAX module, qualified name,
# parameter or None for the name itself), "*" patterns allowed -> the
# port's names that stand in its place (the counterpart must have one of
# them; () when nothing does).
DIFFERENCES = {
    # JAX draws from PRNG keys; the port from a seed or a torch.Generator
    ("*", "*", "key"): ("seed", "generator"),
    ("*", "*", "next_key"): ("seed",),
    ("serving/engine", "spec_accept", "kacc"): ("generator",),
    ("serving/engine", "spec_accept", "kextra"): ("generator",),
    ("utils/prng", "key_seq", None): (),
    ("utils/__init__", "key_seq", None): (),
    # a jnp dtype; the port's configs give the torch dtype
    ("models/*", "*Config.jdtype", None): ("tdtype",),
    # one process drives one device (SPMD over torch.distributed): a mesh
    # takes the rank's device, not a list; the process group takes an init
    # method, a world size and a rank where jax.distributed takes a
    # coordinator; collectives are explicit, so there is no shard_map
    ("parallel/mesh", "make_mesh", "devices"): ("device",),
    ("parallel/mesh", "initialize_distributed", "coordinator"): ("init_method",),
    ("parallel/mesh", "initialize_distributed", "num_processes"): ("world_size",),
    ("parallel/mesh", "initialize_distributed", "process_id"): ("rank",),
    ("parallel/tp_ops", "shard_map", None): (),
    # the stage count is the pipe axis's size, and the dryrun's device
    # count the process group's world size
    ("parallel/pipeline", "stack_stages", "n_stages"): ("mesh",),
    ("parallel/dryrun", "run_dryrun", "n_devices"): (),
    # a checkpoint holds a module's parameters and buffers, not any pytree
    ("utils/checkpoint", "save_checkpoint*", "tree"): ("model",),
    # bench_ms times CUDA events around calls queued behind a device sleep;
    # JAX's differences two in-jit scan lengths
    ("utils/profiling", "bench_ms", "f"): ("fn",),
    ("utils/profiling", "bench_ms", "base"): ("warmup",),
    ("utils/profiling", "bench_ms", "repeats"): ("iters",),
    # the Pallas entry points' weights: the port's wrappers take a weight
    # whole (codes and scales in one QuantizedWeight or QuantizedWeight4),
    # and K8's codes K-major
    ("ops/pallas/quantized_matmul", "quantized_matmul_prequant_pallas", "cw"): ("wq",),
    ("ops/pallas/w4a8_matmul", "w4a8_matmul_pallas", "wp"): ("wq4",),
    ("ops/pallas/w4a8_matmul", "w4a8_matmul_pallas", "cw"): ("wq4",),
    ("ops/pallas/expert_matmul", "grouped_quantized_matmul_pallas", "wq"): ("wt",),
    # Pallas-only helpers: TPU tile sizes, VMEM budgets, unroll factors and
    # the kernels' output dtype (the port's write f32)
    ("ops/pallas/*", "*", "block_*"): (),
    ("ops/pallas/*", "*_pallas", "out_dtype"): (),
    ("ops/pallas/paged_attention", "paged_context_vmem_ok", None): (),
    ("ops/pallas/paged_attention", "RAGGED_UNROLL", None): (),
    ("ops/pallas/paged_attention", "CTX_UNROLL", None): (),
}


def _jax_modules() -> list:
    return sorted(p.relative_to(JAX_ROOT).with_suffix("").as_posix()
                  for p in JAX_ROOT.rglob("*.py"))


def _public(name: str) -> bool:
    return not name.startswith("_") or name == "__version__"


def _args(fn: ast.FunctionDef) -> list:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs if x.arg not in ("self", "cls")]


def _jax_names(rel: str) -> dict:
    """name -> ("def", params) | ("class", {method: params}, [attributes])
    | ("name",) for one module of the JAX package."""
    tree = ast.parse((JAX_ROOT / f"{rel}.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and _public(node.name):
            out[node.name] = ("def", _args(node))
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            methods, attrs = {}, []
            for b in node.body:
                if isinstance(b, ast.FunctionDef):
                    if any(ast.unparse(d) == "property" for d in b.decorator_list):
                        if _public(b.name):
                            attrs.append(b.name)
                    elif _public(b.name) or b.name in ("__init__", "__call__"):
                        methods[b.name] = _args(b)
                elif isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name):
                    attrs.append(b.target.id)
            out[node.name] = ("class", methods, attrs)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                if isinstance(t, ast.Name) and _public(t.id):
                    out[t.id] = ("name",)
        elif isinstance(node, ast.ImportFrom) and rel.endswith("__init__"):
            for a in node.names:
                out[a.asname or a.name] = ("name",)
    return out


def _port_module(rel: str):
    rel = rel.replace("ops/pallas", "ops/cuda")
    rel = rel[:-len("/__init__")] if rel.endswith("/__init__") else rel
    name = "qgemm_tpu_torch" if rel == "__init__" else "qgemm_tpu_torch." + rel.replace("/", ".")
    return importlib.import_module(name)


def _port_object(rel: str, name: str):
    if f"{rel}.{name}" in RENAMED:
        mod, attr = RENAMED[f"{rel}.{name}"].rsplit(".", 1)
        return getattr(_port_module(mod), attr)
    for mod in MODULES.get(rel, (rel,)):
        m = _port_module(mod)
        if hasattr(m, name):
            return getattr(m, name)
    return None


def _instance_attributes(cls) -> set:
    """Attributes a class and its port bases annotate (dataclass and
    NamedTuple fields), set on ``self`` in any method, or register as
    parameters and buffers."""
    names = set()
    for base in cls.__mro__:
        if not base.__module__.startswith("qgemm_tpu_torch"):
            continue
        names.update(vars(base).get("__annotations__", {}))
        for node in ast.walk(ast.parse(inspect.getsource(base).lstrip())):
            targets = node.targets if isinstance(node, ast.Assign) else \
                [node.target] if isinstance(node, ast.AnnAssign) else []
            for t in targets:
                for e in t.elts if isinstance(t, ast.Tuple) else [t]:
                    if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name) \
                            and e.value.id == "self":
                        names.add(e.attr)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("register_buffer", "register_parameter") \
                    and node.args and isinstance(node.args[0], ast.Constant):
                names.add(node.args[0].value)
    return names


def _matches(entry: tuple, rel: str, qualname: str, param) -> bool:
    mod, qual, p = entry
    return fnmatch.fnmatch(rel, mod) and fnmatch.fnmatch(qualname, qual) and (
        p == param if p is None or param is None else fnmatch.fnmatch(param, p))


def _difference(rel: str, qualname: str, param):
    """The port's stand-ins of a deliberate difference, or None."""
    for entry, instead in DIFFERENCES.items():
        if _matches(entry, rel, qualname, param):
            return instead
    return None


def _missing_params(rel: str, qualname: str, params: list, port_fn) -> list:
    try:
        have = set(inspect.signature(port_fn).parameters)
    except (TypeError, ValueError):
        return [f"{qualname}: the port's counterpart has no signature"]
    bad = []
    for p in params:
        if p in have:
            continue
        instead = _difference(rel, qualname, p)
        if instead is None or (instead and not have.intersection(instead)):
            bad.append(f"{qualname}({p})" + (f": none of {instead}" if instead else ""))
    return bad


def _gaps(rel: str) -> list:
    """Every public name of one JAX module that lacks its counterpart."""
    gaps = []
    for name, info in _jax_names(rel).items():
        obj = _port_object(rel, name)
        if obj is None:
            instead = _difference(rel, name, None)
            if instead is None or (instead and not any(_port_object(rel, i) for i in instead)):
                gaps.append(name)
            continue
        if info[0] == "def":
            gaps += _missing_params(rel, name, info[1], obj)
        elif info[0] == "class":
            attrs = set(dir(obj)) | _instance_attributes(obj)
            for meth, params in info[1].items():
                port_meth = getattr(obj, "forward" if meth == "__call__" else meth, None)
                if port_meth is None:
                    gaps.append(f"{name}.{meth}")
                else:
                    gaps += _missing_params(rel, f"{name}.{meth}", params, port_meth)
            for attr in info[2]:
                instead = _difference(rel, f"{name}.{attr}", None)
                if attr not in attrs and (instead is None or not attrs.intersection(instead)):
                    gaps.append(f"{name}.{attr}")
    return gaps


@pytest.mark.parametrize("rel", _jax_modules())
def test_surface_has_every_public_name(rel):
    assert _gaps(rel) == []


def test_every_difference_is_used():
    """Each entry of ``DIFFERENCES`` names something the JAX package has
    and the port does not: a stale entry would hide a new gap."""
    used = set()
    for rel in _jax_modules():
        for name, info in _jax_names(rel).items():
            items = [(name, None)]
            if info[0] == "def":
                items += [(name, p) for p in info[1]]
            elif info[0] == "class":
                items += [(f"{name}.{m}", p) for m, ps in info[1].items() for p in ps]
                items += [(f"{name}.{a}", None) for a in info[2]]
            used.update(entry for entry in DIFFERENCES
                        if any(_matches(entry, rel, q, param) for q, param in items))
    assert set(DIFFERENCES) - used == set()


# --------------------------------------------------------------- the new names

def test_version_and_flops_per_sec():
    assert qgemm_tpu_torch.__version__ == qgemm_tpu.__version__
    for ms, flops in ((1.0, 2 * 2048 ** 3), (0.037, 123456789), (250.0, 1)):
        assert tprof.flops_per_sec(ms, flops) == jprof.flops_per_sec(ms, flops)


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("axis", [0, 1, -1, -2])
def test_layernorm_axis_matches_jax(axis, affine):
    x = _x((3, 5, 16), 0, 2.0) + 0.5
    kw_j, kw_t = {}, {}
    if affine:   # gamma and beta along the normalized axis, broadcast as JAX does
        a = axis % 3
        shape = (x.shape[a],) + (1,) * (2 - a)
        gamma, beta = _x(shape, 1) + 1.0, _x(shape, 2)
        kw_j = dict(gamma=jnp.asarray(gamma), beta=jnp.asarray(beta))
        kw_t = dict(gamma=torch.from_numpy(gamma), beta=torch.from_numpy(beta))
    want = np.asarray(jln.layernorm(jnp.asarray(x), axis=axis, **kw_j))
    got = tln.layernorm(torch.from_numpy(x), axis=axis, **kw_t)
    assert tuple(got.shape) == x.shape
    assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [None, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_weights_int4_dtype_matches_jax(dtype, k):
    w = _x((300, 24), 3, 0.1)
    jwq = jq.quantize_weights_int4(jnp.asarray(w))
    twq = tq.QuantizedWeight4.from_kn(torch.from_numpy(np.array(jwq.qp)),
                                      torch.from_numpy(np.array(jwq.c)))
    want = jq.dequantize_weights_int4(jwq, k=k, dtype=getattr(jnp, dtype))
    got = tq.dequantize_weights_int4(twq, k=k, dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _outlier_data(m=33, k=300, n=72, seed=0):
    """Activations with three planted outlier columns, weights ~ N(0, 1/k)
    (tests/test_torch_outlier.py's data)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[:, [5, 40, 200]] *= 60.0
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return x, w


def _port_wq(jwq):
    if isinstance(jwq, jq.QuantizedWeight4):
        return tq.QuantizedWeight4.from_kn(torch.from_numpy(np.array(jwq.qp)),
                                           torch.from_numpy(np.array(jwq.c)))
    return tq.QuantizedWeight.from_kn(torch.from_numpy(np.array(jwq.q)),
                                      torch.from_numpy(np.array(jwq.c)))


def _close_to_max(got, want):
    want = np.asarray(want)
    assert_allclose(got, want, rtol=0, atol=1e-6 * float(np.abs(want).max()))


def _backend_cases():
    """name -> (JAX's result with backend="xla", the port's call on CPU
    tensors taking a backend, a comparison)."""
    x, w = _x((7, 96), 4, 3.0), _x((96, 130), 5, 0.1)
    xo, wo = _outlier_data()
    jwq, jwo = jq.quantize_weights(jnp.asarray(w)), jq.quantize_weights(jnp.asarray(wo))
    jwo4 = jq.quantize_weights_int4(jnp.asarray(wo))
    tx, tw, txo, two = (torch.from_numpy(a) for a in (x, w, xo, wo))
    exact = lambda got, want: assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
    outlier = dict(threshold=6.0, capacity=8)
    return {
        "prequant": (lambda: jq.quantized_matmul_prequant(jnp.asarray(x), jwq, backend="xla"),
                     lambda b: tq.quantized_matmul_prequant(tx, _port_wq(jwq), backend=b),
                     exact),
        "dynamic": (lambda: jq.quantized_matmul(jnp.asarray(x), jnp.asarray(w), backend="xla"),
                    lambda b: tq.quantized_matmul(tx, tw, backend=b), exact),
        "prequant_outlier_int8": (
            lambda: jq.quantized_matmul_prequant_outlier(jnp.asarray(xo), jwo, backend="xla",
                                                         **outlier),
            lambda b: tq.quantized_matmul_prequant_outlier(txo, _port_wq(jwo), backend=b,
                                                           **outlier), _close_to_max),
        "prequant_outlier_int4": (
            lambda: jq.quantized_matmul_prequant_outlier(jnp.asarray(xo), jwo4, backend="xla",
                                                         **outlier),
            lambda b: tq.quantized_matmul_prequant_outlier(txo, _port_wq(jwo4), backend=b,
                                                           **outlier), _close_to_max),
        "outlier": (lambda: jq.quantized_matmul_outlier(jnp.asarray(xo), jnp.asarray(wo),
                                                        threshold=6.0, backend="xla"),
                    lambda b: tq.quantized_matmul_outlier(txo, two, threshold=6.0, backend=b),
                    _close_to_max),
    }


@pytest.fixture(scope="module")
def backend_cases():
    return {name: (jax_fn(), port, compare)
            for name, (jax_fn, port, compare) in _backend_cases().items()}


@pytest.mark.parametrize("backend", ["auto", "plain"])
@pytest.mark.parametrize("name", ["prequant", "dynamic", "prequant_outlier_int8",
                                  "prequant_outlier_int4", "outlier"])
def test_backend_matches_jax_xla(backend_cases, name, backend):
    want, port, compare = backend_cases[name]
    got = port(backend)
    assert got.dtype == torch.float32
    compare(got, want)


@pytest.mark.parametrize("name", ["prequant", "dynamic", "prequant_outlier_int8",
                                  "prequant_outlier_int4", "outlier"])
def test_backend_kernel_on_cpu_and_unknown_raise(backend_cases, name):
    port = backend_cases[name][1]
    with pytest.raises(RuntimeError, match="kernel"):
        port("kernel")          # a CPU tensor: never the plain version in silence
    for bad in ("xla", "pallas", "cuda", ""):
        with pytest.raises(ValueError, match="backend"):
            port(bad)


def test_prequant_w4_backend():
    x, w = _outlier_data(m=5, seed=6)
    wq4 = tq.quantize_weights_int4(torch.from_numpy(w))
    tx = torch.from_numpy(x)
    want = tq.w4a8_matmul_plain(tx, wq4)
    for b in ("auto", "plain"):
        assert torch.equal(tq.quantized_matmul_prequant_w4(tx, wq4, backend=b), want)
    with pytest.raises(RuntimeError):
        tq.quantized_matmul_prequant_w4(tx, wq4, backend="kernel")
    with pytest.raises(ValueError):
        tq.quantized_matmul_prequant_w4(tx, wq4, backend="xla")


@pytest.mark.parametrize("bits", [8, 4])
def test_matmul_fn_matches_jax(bits):
    """``matmul_fn`` replaces the inlier product (here: twice it), the split
    and the outlier product stay."""
    x, w = _outlier_data(seed=7)
    jw = jnp.asarray(w)
    jwq = jq.quantize_weights_int4(jw) if bits == 4 else jq.quantize_weights(jw)
    if bits == 4:
        jfn = lambda xi, wq: 2.0 * jq.quantized_matmul_prequant_w4(xi, wq)
        tfn = lambda xi, wq: 2.0 * tq.quantized_matmul_prequant_w4(xi, wq)
    else:
        jfn = lambda xi, wq: 2.0 * jq.quantized_matmul_prequant(xi, wq, backend="xla")
        tfn = lambda xi, wq: 2.0 * tq.quantized_matmul_prequant(xi, wq)
    kw = dict(threshold=6.0, capacity=8)
    want = jq.quantized_matmul_prequant_outlier(jnp.asarray(x), jwq, matmul_fn=jfn, **kw)
    got = tq.quantized_matmul_prequant_outlier(torch.from_numpy(x), _port_wq(jwq),
                                               matmul_fn=tfn, **kw)
    _close_to_max(got, want)
    plain = tq.quantized_matmul_prequant_outlier(torch.from_numpy(x), _port_wq(jwq), **kw)
    assert not torch.allclose(got, plain)


def _metric_inputs():
    rng = np.random.default_rng(8)
    a = rng.standard_normal((17, 9))
    b = a + rng.standard_normal((17, 9)) * 1e-7
    return [(a, b), (a, a + 1.0), (a, np.zeros_like(a)), (np.zeros((4,)), np.zeros((4,))),
            (a, a.T), (a[:5], a)]


@pytest.mark.parametrize("case", range(6))
def test_testing_metrics_match_jax(case):
    a, b = _metric_inputs()[case]
    for ta in (a, torch.from_numpy(a).to(torch.float32)):
        fa = np.asarray(ttest.to_numpy(ta), dtype=np.float64)
        assert ttest.allclose(ta, b) == jtest.allclose(fa, b)
        assert ttest.allclose(ta, b, rtol=1e-3, atol=0) == jtest.allclose(fa, b, rtol=1e-3,
                                                                          atol=0)
        if fa.shape == np.shape(b):
            assert abs(ttest.mean_abs_error(ta, b) - jtest.mean_abs_error(fa, b)) <= 1e-12
            assert abs(ttest.rel_fro_error(ta, b) - jtest.rel_fro_error(fa, b)) \
                <= 1e-12 * max(1.0, jtest.rel_fro_error(fa, b))


def _trace_names(path) -> set:
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_writes_a_file_naming_the_ops_inside(tmp_path):
    a = torch.ones((8, 8))
    with tprof.trace(str(tmp_path / "t")) as t:
        torch.mm(a, a)
    assert Path(t.path).parent == tmp_path / "t"
    assert "aten::mm" in _trace_names(t.path)


def test_trace_stops_on_an_exception_and_refuses_nesting(tmp_path):
    a = torch.ones((8, 8))
    with pytest.raises(KeyError):
        with tprof.trace(str(tmp_path)) as t:
            torch.mm(a, a)
            raise KeyError("inside")
    assert not torch.autograd._profiler_enabled()
    assert "aten::mm" in _trace_names(t.path)
    with tprof.trace(str(tmp_path)) as outer:
        with pytest.raises(RuntimeError, match="already running"):
            with tprof.trace(str(tmp_path / "inner")):
                pass
        torch.add(a, a)
    assert "aten::add" in _trace_names(outer.path)
    assert not (tmp_path / "inner").exists()
