"""Every parameter of khg_tpu's public API has its counterpart in the
port (khg_tpu_torch), or stands in one of the tables below with its
reason.

Signatures are read from the source by ``ast``, so no device and no jit
wrapper is involved.  Each module of khg_tpu is paired with the port's
module of the same path, the kernel modules by ``MODULE_RENAMES``.  For
every public function, every public method and constructor of a public
class, and every field of a dataclass or NamedTuple, each reference
parameter must appear in the port's counterpart under its own name, or
under its ``PARAM_RENAMES`` name, or be one of ``TPU_ONLY`` (mechanics
of the TPU kernels and of JAX that a CUDA port has no use for).  A
function without a same-named counterpart must stand in
``FUNCTION_RENAMES`` (its parameters are then checked against the
renamed one) or in ``TPU_ONLY_FUNCTIONS``.
"""

import ast
import functools
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "khg_tpu"
PORT = ROOT / "khg_tpu_torch"

# reference module -> the port's module (paths below the package)
MODULE_RENAMES = {
    "align/pallas_banded": "align/banded_kernel",
    "align/pallas_banded_fb": "align/banded_fb",
    "align/pallas_viterbi": "align/viterbi_kernel",
    "features/pallas_fbank": "features/fbank_kernel",
    "gmm/pallas_kernels": "gmm/fused_loglikes",
    "stats/pallas_fold": "stats/fold_kernel",
}

# parameters of TPU mechanics, and why the port has none
TPU_ONLY = {
    "unroll": "lax.scan unrolling; the port's loops are eager or in a kernel",
    "interpret": "Pallas interpret mode; a CPU tensor runs the plain version",
    "block_b": "utterances per Pallas grid step, sized to VMEM",
    "lane": "state axis padded to the TPU's 128 lanes",
    "time_chunk": "frames per VMEM block of a Pallas kernel",
    "tn": "frame tile of the Pallas loglikes kernel",
    "tp": "pdf tile of the Pallas loglikes kernel",
    "external_ac": "acoustic lattice streamed from HBM beside VMEM tables",
    "banded_interpret": "Pallas interpret mode of the sharded banded kernels",
    "max_in_flight": "async dispatch depth of JAX's host loop",
    "use_pallas": "TPU frontend switch; the tensor's device picks the kernel",
}

# reference parameter -> the port's name for it
PARAM_RENAMES = {
    "dither_key": ("dither_generator", "a torch.Generator, not a JAX key"),
    "loglikes_dev": ("loglikes", "device scores are the port's only form"),
    "banded": ("tables", "the banded tables as torch tensors"),
    "plane_offsets": ("offsets", "the per-plane offsets of the tables"),
}

# reference function without a same-named counterpart -> (port module,
# port function, reason)
FUNCTION_RENAMES = {
    ("align/pallas_viterbi", "viterbi_align_batch_pallas"): (
        "align/viterbi", "viterbi_align_batch",
        "kernel G runs under viterbi_align_batch for CUDA tensors"),
    ("features/pallas_fbank", "compute_fbank_pallas"): (
        "features/fbank_kernel", "fbank_fused",
        "kernel C's entry point"),
    ("features/mfcc", "compute_mfcc_pallas"): (
        "features/mfcc", "compute_mfcc_batch",
        "compute_mfcc_batch runs kernel C for CUDA tensors"),
    ("gmm/pallas_kernels", "loglikes_pallas"): (
        "gmm/fused_loglikes", "loglikes_fused",
        "kernel B's entry point"),
    ("stats/pallas_fold", "accumulate_am_stats_fold_pallas"): (
        "stats/fold_kernel", "accumulate_am_stats_fold",
        "kernel F's entry point"),
}

# reference functions of TPU mechanics, and why the port has none
TPU_ONLY_FUNCTIONS = {
    ("align/pallas_banded", "banded_vmem_bytes"): "VMEM sizing (port: kernel_fits)",
    ("align/pallas_banded", "banded_scratch_bytes"): "VMEM sizing (port: kernel_fits)",
    ("align/pallas_banded", "pick_block_b"): "Pallas grid blocking",
    ("align/pallas_banded_fb", "banded_fb_vmem_bytes"): "VMEM sizing (port: fb_kernel_fits)",
    ("align/pallas_banded_fb", "banded_fb_scratch_bytes"): "VMEM sizing (port: fb_kernel_fits)",
    ("align/pallas_viterbi", "viterbi_vmem_bytes"): "VMEM sizing (port: viterbi_plan)",
    ("align/viterbi", "make_factored_select"): "one-hot gather for the MXU; the port indexes",
    ("model/transition_device", "factored_take"): "one-hot gather for the MXU; the port indexes",
    ("utils/platform", "ensure_backend"): "JAX backend start-up (port: resolve_device)",
}


def _params(fn: ast.FunctionDef):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


@functools.lru_cache(maxsize=None)
def signatures(path: Path):
    """{name: [parameters]} of a module's public functions, of its
    public classes' public methods and constructors (``Class.method``),
    and of its classes' annotated fields (``Class()``)."""
    out = {}
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            fields = [b.target.id for b in node.body
                      if isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name)]
            if fields:
                out[f"{node.name}()"] = fields
            for b in node.body:
                if isinstance(b, ast.FunctionDef) and (
                        b.name == "__init__" or not b.name.startswith("_")):
                    out[f"{node.name}.{b.name}"] = _params(b)
    return out


def _module(path: Path, root: Path) -> str:
    return str(path.relative_to(root).with_suffix(""))


REF_MODULES = sorted(
    m for m in (_module(p, REF) for p in REF.rglob("*.py"))
    if (PORT / (MODULE_RENAMES.get(m, m) + ".py")).exists()
)


def counterpart(module: str, name: str, port_root: Path = PORT):
    """The parameters of the port's counterpart of ``module.name``
    (same name in the paired module, else its FUNCTION_RENAMES entry),
    or None."""
    port = signatures(port_root / (MODULE_RENAMES.get(module, module) + ".py"))
    if name in port:
        return port[name]
    if (module, name) in FUNCTION_RENAMES:
        other, fn, _why = FUNCTION_RENAMES[(module, name)]
        return signatures(port_root / (other + ".py")).get(fn)
    return None


def missing_parameters(module: str, port_root: Path = PORT):
    """[(module, function, parameter)] of the reference that the port
    lacks, after the tables; [(module, function, None)] for a function
    with no counterpart."""
    out = []
    for name, params in sorted(signatures(REF / (module + ".py")).items()):
        if (module, name) in TPU_ONLY_FUNCTIONS:
            continue
        have = counterpart(module, name, port_root)
        if have is None:
            out.append((module, name, None))
            continue
        for p in params:
            if p in have or p in TPU_ONLY:
                continue
            if p in PARAM_RENAMES and PARAM_RENAMES[p][0] in have:
                continue
            out.append((module, name, p))
    return out


def test_modules_are_paired():
    """Every reference module that has a counterpart is walked below,
    each kernel module by its rename, and every module of khg_tpu has
    one: the port has no module left to write."""
    assert set(MODULE_RENAMES) <= set(REF_MODULES)
    unpaired = sorted(m for m in (_module(p, REF) for p in REF.rglob("*.py"))
                      if m not in REF_MODULES)
    assert not unpaired, unpaired


@pytest.mark.parametrize("module", REF_MODULES)
def test_reference_parameters_exist_in_the_port(module):
    assert missing_parameters(module) == []


def test_every_table_entry_is_used():
    """No entry of the tables excuses what no longer exists: each names
    a reference function, or a parameter that some reference function
    has and the port's counterpart lacks."""
    ref = {m: signatures(REF / (m + ".py")) for m in REF_MODULES}
    for key in list(FUNCTION_RENAMES) + list(TPU_ONLY_FUNCTIONS):
        module, name = key
        assert name in ref[module], key
    used = set()
    for m in REF_MODULES:
        for name, params in ref[m].items():
            have = counterpart(m, name)
            if have is not None:
                used.update(p for p in params if p not in have)
    assert set(TPU_ONLY) <= used, sorted(set(TPU_ONLY) - used)
    assert set(PARAM_RENAMES) <= used, sorted(set(PARAM_RENAMES) - used)


def test_exemptions_hold_no_semantic_parameter():
    """The tables excuse TPU mechanics and renames only: dither, careful
    alignment, the compute dtype, precomputed scores and state_pdf are
    ported under their own names (dither_key as dither_generator)."""
    semantic = {"careful", "compute_dtype", "state_scores", "state_pdf",
                "dither", "dither_key"}
    assert not semantic & set(TPU_ONLY)
    assert set(PARAM_RENAMES) & semantic == {"dither_key"}
    assert PARAM_RENAMES["dither_key"][0] == "dither_generator"


def test_a_removed_parameter_is_caught(tmp_path):
    """The walk fails on a port whose pack_graphs has lost ``careful``
    (a copy of the port's pipeline module with the parameter deleted)."""
    src = (PORT / "recipes" / "pipeline.py").read_text()
    old = "self, graphs: Sequence[VectorFst], careful: bool = False\n"
    assert old in src
    (tmp_path / "recipes").mkdir()
    (tmp_path / "recipes" / "pipeline.py").write_text(
        src.replace(old, "self, graphs: Sequence[VectorFst]\n"))
    got = missing_parameters("recipes/pipeline", port_root=tmp_path)
    assert ("recipes/pipeline", "EStepPipeline.pack_graphs", "careful") in got
    assert missing_parameters("recipes/pipeline") == []
