"""The port's CTC runner (khg_tpu_torch/egs/ctc_synth.py, device="cpu")
against egs/ctc_synth/run.py at tests/test_ctc_train.py's arguments:
wer.txt equal byte for byte, WER 0.00%, and stage-2 re-entry from the
saved artifacts reproducing it."""

import importlib.util
from pathlib import Path

from khg_tpu_torch.egs import ctc_synth

REPO = Path(__file__).resolve().parents[1]
ARGS = ["--num-train", "24", "--num-test", "6", "--num-passes", "8"]


def _run_py():
    spec = importlib.util.spec_from_file_location(
        "ctc_synth_run_py", REPO / "egs" / "ctc_synth" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ctc_synth_runner_matches_run_py(tmp_path):
    assert _run_py().main(["--exp-dir", str(tmp_path / "jax"), *ARGS]) == 0.0
    ref = (tmp_path / "jax" / "wer.txt").read_bytes()
    exp = tmp_path / "port"
    out = ctc_synth.main(["--exp-dir", str(exp), "--device", "cpu", *ARGS])
    assert out["wer"] == 0.0
    assert (exp / "wer.txt").read_bytes() == ref
    assert out["history"][-1] > out["history"][0]
    # stage re-entry: decode only, from the saved model and corpus
    again = ctc_synth.main(["--exp-dir", str(exp), "--stage", "2", "--device", "cpu"])
    assert again["wer"] == out["wer"] and "history" not in again
    assert (exp / "wer.txt").read_bytes() == ref
