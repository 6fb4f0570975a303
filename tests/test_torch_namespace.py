"""The port's flat namespaces hold every public name of khg_tpu's
(khg_tpu/__init__.py, features/__init__.py, data/__init__.py), each
resolving to the port's counterpart, imported on first use."""

import subprocess
import sys
from pathlib import Path

import pytest

import khg_tpu
import khg_tpu.data
import khg_tpu.features
import khg_tpu_torch
import khg_tpu_torch.data
import khg_tpu_torch.features

ROOT = Path(__file__).resolve().parent.parent
PAIRS = {
    "root": (khg_tpu, khg_tpu_torch),
    "features": (khg_tpu.features, khg_tpu_torch.features),
    "data": (khg_tpu.data, khg_tpu_torch.data),
}


def _public(mod):
    return {n for n in vars(mod) if not n.startswith("_")
            and not isinstance(vars(mod)[n], type(sys))}


@pytest.mark.parametrize("which", sorted(PAIRS))
def test_port_names_are_a_superset(which):
    ref, port = PAIRS[which]
    missing = sorted(_public(ref) - set(dir(port)))
    assert not missing, missing
    for name in _public(ref):
        value = getattr(port, name)
        assert getattr(value, "__module__", "khg_tpu_torch").startswith(
            "khg_tpu_torch"), (name, value)


def test_kernel_entry_keeps_the_reference_name():
    from khg_tpu_torch.features.fbank_kernel import fbank_fused

    assert khg_tpu_torch.compute_fbank_pallas is fbank_fused
    assert khg_tpu_torch.features.compute_fbank_pallas is fbank_fused


def test_names_import_on_first_use():
    """Importing the package, or one subpackage, imports no other."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import khg_tpu_torch.data.wav, khg_tpu_torch.parallel\n"
        "mods = sorted(m for m in sys.modules if m.startswith('khg_tpu_torch.'))\n"
        "print(mods)\n"
        "assert not any(m.startswith(('khg_tpu_torch.gmm', 'khg_tpu_torch.align',"
        " 'khg_tpu_torch.features', 'khg_tpu_torch.recipes')) for m in mods), mods\n"
        % str(ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_importing_the_port_switches_tf32_off():
    """fp32 products and convolutions stay full fp32 (khg_tpu's
    precision=HIGHEST): importing the package turns TF32 off for cuBLAS
    and cuDNN, whatever names it loads lazily."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import torch\n"
        "torch.backends.cuda.matmul.allow_tf32 = True\n"
        "torch.backends.cudnn.allow_tf32 = True\n"
        "import khg_tpu_torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n"
        % str(ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
