"""Staged recipes of the port, run as modules
(``python -m khg_tpu_torch.egs.audiomnist_10k``)."""
