"""khg_tpu_torch — the PyTorch/CUDA port of khg_tpu for NVIDIA Hopper.

Host-side modules (lexicon, FSTs, topology, transition model, graph
compiler, GMM containers, MLE) are numpy copies of khg_tpu's; device
work runs in PyTorch, with hand-written CUDA kernels (``csrc/``) where
khg_tpu ran Pallas kernels.  Nothing here imports jax or khg_tpu.

fp32 matrix products stay full fp32 (the counterpart of khg_tpu's
``precision=HIGHEST``): TF32 is switched off for cuBLAS and cuDNN.

The flat namespace of khg_tpu (``import khg_tpu_torch as k;
k.TransitionModel``) resolves each name on first use (a module
``__getattr__``), so a process that needs one subpackage (a spawned
rank of parallel/, a worker reading WAVs) imports only that one.
"""

import torch

from khg_tpu_torch.utils.lazy import lazy_exports

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

_EXPORTS = {
    "model.topology": ["HmmTopology"],
    "model.context_dep": [
        "ContextDependency", "monophone_context_dependency",
        "monophone_context_dependency_shared",
    ],
    "model.transition_model": [
        "MleTransitionUpdateConfig", "TransitionModel", "get_pdfs_for_phones",
    ],
    "gmm.diag_gmm": ["DiagGmm"],
    "gmm.am_gmm": ["AmDiagGmm", "get_split_targets"],
    "est.flags": [
        "GMM_ALL", "GMM_MEANS", "GMM_TRANSITIONS", "GMM_VARIANCES",
        "GMM_WEIGHTS", "gmm_flags_to_str", "str_to_gmm_flags",
    ],
    "est.mle": [
        "MapDiagGmmOptions", "MleDiagGmmOptions", "gmm_boost_silence",
        "map_am_diag_gmm_update", "map_diag_gmm_update", "ml_objective",
        "mle_am_diag_gmm_update", "mle_diag_gmm_update",
    ],
    "stats.accum": ["AccumAmDiagGmm", "AccumDiagGmm"],
    "graph.compiler": ["TrainingGraphCompiler", "TrainingGraphCompilerOptions"],
    "graph.h_builder": [
        "add_self_loops", "add_transition_probs", "get_h_transducer",
        "modify_graph_for_careful_alignment",
    ],
    "decode.decoder": ["FasterDecoder", "FasterDecoderOptions"],
    "decode.lattice": [
        "LatticeFasterDecoder", "LatticeFasterDecoderConfig",
        "LatticeSimpleDecoder", "decode_utterance_lattice_faster",
    ],
    "decode.score_stream": ["decode_scores_streamed", "stream_scores"],
    "decode.decodable": ["DecodableAmDiagGmmScaled", "DecodableCtc"],
    "model.kaldi_binary": [
        "load_transition_model", "load_tree", "save_transition_model",
        "save_tree",
    ],
    "features": [
        "FbankConfig", "compute_fbank", "compute_fbank_batch",
        "compute_fbank_pallas",
    ],
    "data": ["read_wav", "wav_info", "write_wav"],
}
globals().update(lazy_exports(globals(), _EXPORTS))
