"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

The port (khg_tpu_torch) and the reference (khg_tpu) run on identical
inputs: numpy data from fixed seeds, and host objects (models, FSTs,
transition models) carried between the reference's classes and the
port's identical copies by a pickle round trip that renames the modules.
"""

import io
import pickle

import torch

# each xdist worker keeps to two torch threads
torch.set_num_threads(2)


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "khg_tpu" or module.startswith("khg_tpu."):
            module = "khg_tpu_torch" + module[len("khg_tpu"):]
        return super().find_class(module, name)


def port_copy(obj):
    """A deep copy of a reference-package object as the port's class."""
    return _PortUnpickler(io.BytesIO(pickle.dumps(obj))).load()



class _ReferenceUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "khg_tpu_torch" or module.startswith("khg_tpu_torch."):
            module = "khg_tpu" + module[len("khg_tpu_torch"):]
        return super().find_class(module, name)


def reference_copy(obj):
    """A deep copy of a port object as the reference package's class."""
    return _ReferenceUnpickler(io.BytesIO(pickle.dumps(obj))).load()
