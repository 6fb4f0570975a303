"""The port stands alone: no module of khg_tpu_torch, not chip_smoke.py,
and not the worker that the multi-process tests spawn
(tests/torch_multihost_worker.py) imports jax or khg_tpu, and its entry
points never fall back to the CPU without being asked."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "khg_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "khg_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "torch_multihost_worker.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_forbidden_imports_in_source(path):
    """Every import statement, lazy ones inside functions included."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


_BLOCKED = r'''
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})

class Block:
    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "jaxlib", "khg_tpu") or name.startswith(
            ("jax.", "jaxlib.", "khg_tpu.")
        ):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.modules["jax"] = None
import torch
torch.cuda.is_available = lambda: False

import khg_tpu_torch
for m in pkgutil.walk_packages(khg_tpu_torch.__path__, "khg_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
sys.path.insert(0, {root!r} + "/tests")
import torch_multihost_worker

import numpy as np
from khg_tpu_torch.recipes.corpus_train import train_corpus
from khg_tpu_torch.recipes.yesno_wav import WavCorpus, extract_features
from khg_tpu_torch.recipes.pipeline import EStepPipeline
from khg_tpu_torch.decode.decoder import decode_dense
from khg_tpu_torch.egs.audiomnist_10k import main as runner_main, score_held_out
from khg_tpu_torch.fstlib.fst import VectorFst
from khg_tpu_torch.gmm.likelihoods import loglikes_np
from khg_tpu_torch.recipes.yesno import SyntheticCorpus, train_yesno
from khg_tpu_torch.features.mfcc import compute_mfcc_batch
from khg_tpu_torch.features.resample import resample_waveform
from khg_tpu_torch.egs.yesno_synth import main as synth_main
from khg_tpu_torch.egs.yesno_wav import main as wav_main
from khg_tpu_torch.egs.ctc_synth import main as ctc_main
from khg_tpu_torch.recipes.ctc_train import train_ctc_gmm
from khg_tpu_torch.parallel.mesh import make_data_mesh
from khg_tpu_torch.features import compute_fbank

calls = {{
    "train_corpus": lambda: train_corpus(None, [["ONE"]], [np.zeros((5, 3), np.float32)]),
    "extract_features": lambda: extract_features(WavCorpus([], [], [], [])),
    "EStepPipeline": lambda: EStepPipeline(None),
    "score_held_out": lambda: score_held_out(None, []),
    "decode_dense": lambda: decode_dense(VectorFst(), np.zeros((2, 3)), np.zeros(2)),
    "loglikes_np": lambda: loglikes_np(None, np.zeros((2, 3))),
    "audiomnist_10k": lambda: runner_main(["--exp-dir", {tmp!r}]),
    "train_yesno": lambda: train_yesno(
        None, SyntheticCorpus([["YES"]], [np.zeros((5, 3), np.float32)], [])),
    "align_and_accumulate": lambda: EStepPipeline(None).align_and_accumulate(
        None, [], []),
    "compute_mfcc_batch": lambda: compute_mfcc_batch(np.zeros((1, 800), np.float32)),
    "resample_waveform": lambda: resample_waveform(np.zeros(8, np.float32), 8000, 16000),
    "yesno_synth": lambda: synth_main(["--exp-dir", {tmp!r}]),
    "yesno_wav": lambda: wav_main(["--exp-dir", {tmp!r}]),
    "ctc_synth": lambda: ctc_main(["--exp-dir", {tmp!r}]),
    "train_ctc_gmm": lambda: train_ctc_gmm([np.zeros((5, 3), np.float32)], [[1]], 2),
    "make_data_mesh": lambda: make_data_mesh(),
    "compute_fbank": lambda: compute_fbank(np.zeros(800, np.float32)),
}}
for name, call in calls.items():
    try:
        call()
    except RuntimeError as e:
        assert "CUDA" in str(e), (name, e)
    else:
        raise AssertionError(name + " ran without a card and without device='cpu'")
assert not any(k == "jax" or k.startswith(("jax.", "khg_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("BOUNDARY_OK")
'''


def test_imports_and_entry_points_without_jax_or_cuda(tmp_path):
    """In a fresh interpreter where jax and khg_tpu cannot be imported
    and CUDA is absent: every port module and chip_smoke import, and
    train_corpus / extract_features / EStepPipeline / score_held_out /
    decode_dense / loglikes_np / train_yesno / align_and_accumulate /
    compute_mfcc_batch / resample_waveform / train_ctc_gmm /
    make_data_mesh / compute_fbank and the four staged runners called
    without a device raise instead of running on the CPU; the
    multi-process tests' worker imports too."""
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED.format(root=str(ROOT),
                                               tmp=str(tmp_path / "exp"))],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BOUNDARY_OK" in out.stdout


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result line without a
    card, and in a directory holding nothing else of the repo."""
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    out = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        timeout=120, cwd=str(tmp_path),
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
