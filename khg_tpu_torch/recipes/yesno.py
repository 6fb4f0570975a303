"""End-to-end monophone EM training on a synthetic yesno-style corpus.

PyTorch port of khg_tpu/recipes/yesno.py: the host loop is a copy, and
the E-steps (equal-align accumulation, Viterbi realignment) run on the
device through recipes/pipeline.py's EStepPipeline (``device=``: None
means CUDA and raises without a card; "cpu" runs the plain versions).

The real yesno corpus is audio; this recipe generates features directly
from a hidden per-phone-state Gaussian process so the full pipeline
(lang prep -> flat start -> graph compilation -> equal-align ->
EM with periodic Viterbi realignment and Gaussian mix-up) can run
hermetically on any backend and be checked for learning progress.

Structure mirrors the reference recipe
(reference egs/yesno/train.py:36-230) with the per-utterance loops
replaced by the batched device pipeline.

Run:  python -m khg_tpu_torch.recipes.yesno [--device cpu]
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from khg_tpu_torch.est.mle import MleDiagGmmOptions, gmm_boost_silence
from khg_tpu_torch.fstlib.fst import equal_align
from khg_tpu_torch.graph.compiler import TrainingGraphCompiler, TrainingGraphCompilerOptions
from khg_tpu_torch.lang.lexicon import Lexicon, Lexiconp
from khg_tpu_torch.lang.lfst import make_lexicon_fst_with_silence
from khg_tpu_torch.lang.topo import generate_hmm_topo
from khg_tpu_torch.model.transition_model import MleTransitionUpdateConfig
from khg_tpu_torch.recipes.pipeline import EStepPipeline
from khg_tpu_torch.recipes.steps import gmm_est, gmm_info, gmm_init_mono
from khg_tpu_torch.stats.accum import AccumAmDiagGmm
from khg_tpu_torch.utils.platform import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

DEFAULT_REALIGN_ITERS = (
    "1 2 3 4 5 6 7 8 9 10 12 14 16 18 20 23 26 29 32 35 38 40 42 44 46 49 "
    "52 55 58 60 65 70 75 78 79"
)


@dataclass
class SyntheticCorpus:
    word_seqs: List[List[str]]
    feats: List[np.ndarray]
    phone_alignments: List[List[int]]  # hidden generating phone per frame


def make_synthetic_corpus(
    num_utts: int = 10,
    dim: int = 13,
    rng: Optional[np.random.Generator] = None,
    min_words: int = 2,
    max_words: int = 6,
    frames_per_state: Tuple[int, int] = (2, 6),
    emission_std: float = 0.35,
    sil_between_words: float = 1.0,
    allow_repeats: bool = False,
) -> Tuple[Lexiconp, SyntheticCorpus]:
    """Yesno-style corpus drawn from distinct per-(phone,state) Gaussians.

    By default word sequences have no consecutive repeats and silence
    always separates words: with identical per-word emitters, "YES YES"
    without silence is acoustically indistinguishable from a single
    longer "YES" (an inherent HMM ambiguity), which would make exact
    decoding WER ill-defined.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    lexicon = Lexicon(word2phones={"<SIL>": ["SIL"], "YES": ["Y"], "NO": ["N"]})
    lp = Lexiconp.from_lexicon(lexicon).add_lex_disambig()

    # hidden emitters: mean vectors for each (phone, state).  Silence is
    # quiet (small means), like real silence — this anchors the SIL pdfs
    # during flat-start EM exactly as low-energy frames do on real audio;
    # with silence as loud as words, EM can settle into a stable
    # phone-rotation local optimum that no amount of training escapes.
    num_states = {"SIL": 5, "Y": 3, "N": 3}
    emitters: Dict[Tuple[str, int], np.ndarray] = {}
    for ph, ns in num_states.items():
        scale = 0.3 if ph == "SIL" else 2.0
        for s in range(ns):
            emitters[(ph, s)] = rng.standard_normal(dim) * scale

    word_seqs, feats, phone_alis = [], [], []
    for _ in range(num_utts):
        n_words = int(rng.integers(min_words, max_words + 1))
        words: List[str] = []
        for _ in range(n_words):
            choices = ["YES", "NO"]
            if not allow_repeats and words:
                choices = [w for w in choices if w != words[-1]]
            words.append(str(rng.choice(choices)))
        phones: List[str] = ["SIL"]
        for w in words:
            phones.extend({"YES": ["Y"], "NO": ["N"]}[w])
            if rng.random() < sil_between_words:
                phones.append("SIL")
        if phones[-1] != "SIL":
            phones.append("SIL")
        frames = []
        ali = []
        for ph in phones:
            for s in range(num_states[ph]):
                n = int(rng.integers(*frames_per_state))
                if ph == "SIL":
                    # real silences are long relative to words, which is what
                    # anchors the silence pdfs during flat-start EM
                    n = 2 * n + 1
                n = max(n, 1)
                for _ in range(n):
                    frames.append(
                        emitters[(ph, s)]
                        + rng.standard_normal(dim) * emission_std
                    )
                    ali.append(lp.phone2id[ph])
        word_seqs.append(words)
        feats.append(np.asarray(frames, dtype=np.float32))
        phone_alis.append(ali)
    return lp, SyntheticCorpus(word_seqs, feats, phone_alis)


@dataclass
class TrainResult:
    transition_model: object
    tree: object
    am: object
    lexiconp: Lexiconp
    graphs: list
    avg_loglikes: List[float]
    alignments: List[Optional[List[int]]]
    info: Dict[str, int]
    # total Gaussian count after each est step (initial est + one per
    # pass) — the discrete mix-up/min-count/removal schedule
    num_gauss_after_est: List[int] = None


_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) & _M64


def det_split_noise(pass_idx: int, pdf: int, comp: int, dim: int) -> float:
    """Deterministic uniform in [-0.5, 0.5) keyed by (pass, pdf,
    component, dimension) — shared bit-for-bit with the reference-side
    golden runner (tools/refgold/em_loop_runner.cc DetSplitNoise)."""
    key = ((pass_idx + 1) << 40) ^ (pdf << 24) ^ (comp << 12) ^ dim
    return (_splitmix64(key) >> 11) / 9007199254740992.0 - 0.5


def apply_det_split_perturb(am, old_counts, eps: float, pass_idx: int):
    """Perturb NEW components (indices >= the pre-split count) by
    mean += eps * sqrt(var) * det_split_noise(...).

    Run-level golden parity with split perturbation needs the SAME noise
    on both sides, and the reference's own DiagGmm::Split draws from an
    unseedable std::random_device (csrc/eigen.cc:34-46) — so both loops
    apply this deterministic post-split perturbation instead.  At
    perturb 0 the split twins sit on a symmetry ridge: long-horizon
    trajectories then diverge on tie-breaking rounding noise alone
    (measured in round 4; see docs/design.md)."""
    if eps == 0.0:
        return
    for p in range(am.num_pdfs):
        g = am.get_pdf(p)
        changed = False
        for k in range(old_counts[p], g.num_gauss):
            mean = np.asarray(g.get_component_mean(k), dtype=np.float64)
            var = np.asarray(g.get_component_variance(k), dtype=np.float64)
            noise = np.array(
                [det_split_noise(pass_idx, p, k, d)
                 for d in range(mean.shape[0])]
            )
            g.set_component_mean(k, mean + eps * np.sqrt(var) * noise)
            changed = True
        if changed:
            g.compute_gconsts()


def _round_model_f32(am) -> None:
    """Round every DiagGmm's parameters through float32 — the precision
    the reference keeps between passes (FloatMatrix storage) — leaving
    all arithmetic unchanged."""
    for p in range(am.num_pdfs):
        g = am.get_pdf(p)
        g.means_invvars = g.means_invvars.astype(np.float32).astype(
            np.float64
        )
        g.inv_vars = g.inv_vars.astype(np.float32).astype(np.float64)
        g.weights = g.weights.astype(np.float32).astype(np.float64)
        g.compute_gconsts()


def train_yesno(
    lp: Lexiconp,
    corpus: SyntheticCorpus,
    num_iters: int = 20,
    realign_iters: str = DEFAULT_REALIGN_ITERS,
    total_gauss: int = 100,
    max_iter_inc: int = 10,
    acoustic_scale: float = 0.1,
    self_loop_scale: float = 0.1,
    boost: float = 1.0,
    seed: int = 3,
    perturb_factor: float = 0.01,
    checkpoint_dir: Optional[str] = None,
    det_split_perturb: float = 0.0,
    f32_storage: bool = False,
    device: DeviceLike = None,
) -> TrainResult:
    """``f32_storage=True`` rounds the model parameters through float32
    after every M-step, emulating the reference's storage precision
    (its DiagGmm matrices are FloatMatrix, eigen.h:10-16, while khg
    keeps f64 between passes); khg_tpu's twin of this knob is what
    tools/measure_golden_envelope.py uses to measure the trajectory
    drift that tests/test_em_loop_golden.py's envelope tolerates.

    ``device``: where the E-steps run (None means CUDA and raises
    without a card; "cpu" for the plain PyTorch versions).  The Viterbi
    realignment takes align_backend="xla": the incoming-arc kernel
    (csrc/viterbi.cu) on the card."""
    from khg_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    topo = generate_hmm_topo(
        non_sil_phones=lp.get_non_sil_phone_ids(),
        sil_phone=lp.get_sil_phone_id(),
    )

    resume = latest_checkpoint(checkpoint_dir) if checkpoint_dir else None
    if resume is not None:
        state = load_checkpoint(resume)
        tm = state["transition_model"]
        tree = state["tree"]
        am = state["acoustic_model"]
        graphs = state["graphs"]
        alignments = state["alignments"]
        avg_loglikes = state["avg_loglikes"]
        gauss_sched = state.get("num_gauss_after_est", [])
        num_gauss = state["num_gauss"]
        inc_gauss = state["inc_gauss"]
        start_iter = state["iter"] + 1
        rng.bit_generator.state = state["rng_state"]
        logger.info("resumed from %s at pass %d", resume, start_iter)
    else:
        tm, tree, am = gmm_init_mono(topo, corpus.feats)
        info = gmm_info(am, tm)
        num_gauss = info["number_of_gaussians"]
        inc_gauss = (total_gauss - num_gauss) // max_iter_inc
        start_iter = 0
        logger.info("init: %s", info)

        lex_fst = make_lexicon_fst_with_silence(
            lexiconp=lp, sil_prob=0.5, sil_phone="SIL"
        )
        gc = TrainingGraphCompiler(
            trans_model=tm,
            ctx_dep=tree,
            lex_fst=lex_fst,
            disambig_syms=lp.disambig_phone_ids(),
            opts=TrainingGraphCompilerOptions(),
        )
        graphs = []
        for words in corpus.word_seqs:
            word_ids = [lp.word2id[w] for w in words]
            graphs.append(gc.compile_graph_from_text(word_ids))

        # ---- first alignment: equal-align
        alignments = []
        for g, f in zip(graphs, corpus.feats):
            res = equal_align(g, f.shape[0], rng)
            alignments.append(res[0] if res is not None else None)

    pipeline = EStepPipeline(
        tm,
        acoustic_scale=acoustic_scale,
        transition_scale=1.0,
        self_loop_scale=self_loop_scale,
        device=device,
    )

    if resume is None:
        ok = [i for i, a in enumerate(alignments) if a is not None]
        gmm_accs = AccumAmDiagGmm()
        gmm_accs.init(am, flags=0b1111)
        transition_accs = tm.init_stats()
        tot = pipeline.accumulate_from_alignments(
            am,
            [corpus.feats[i] for i in ok],
            [alignments[i] for i in ok],
            gmm_accs,
            transition_accs,
        )
        avg_loglikes = [tot / max(gmm_accs.tot_count, 1.0)]
        logger.info(
            "pass 0 (equal-align) avg log-like/frame: %.4f", avg_loglikes[-1]
        )

        gmm_opts0 = MleDiagGmmOptions(min_gaussian_occupancy=3.0)
        old_counts = [am.get_pdf(p).num_gauss for p in range(am.num_pdfs)]
        gmm_est(
            am, gmm_accs, tm, transition_accs,
            MleTransitionUpdateConfig(), gmm_opts0,
            mixup=num_gauss, perturb_factor=perturb_factor, rng=rng,
        )
        apply_det_split_perturb(am, old_counts, det_split_perturb, 0)
        if f32_storage:
            _round_model_f32(am)
        gauss_sched = [am.num_gauss]

    realign_set = set(realign_iters.split())
    packed_base = pipeline.pack_graphs_base(graphs)
    for it in range(start_iter, num_iters):
        if str(it) in realign_set:
            boosted = gmm_boost_silence(
                am, tm, [lp.get_sil_phone_id()], boost=boost
            )
            packed = pipeline.refresh_transition_costs(packed_base)
            res = pipeline.align_and_accumulate(
                boosted, packed, corpus.feats, accumulate=False
            )
            for i, a in enumerate(res.alignments):
                if a is not None:
                    alignments[i] = a
        gmm_accs = AccumAmDiagGmm()
        gmm_accs.init(am, flags=0b1111)
        transition_accs = tm.init_stats()
        ok = [i for i, a in enumerate(alignments) if a is not None]
        tot = pipeline.accumulate_from_alignments(
            am,
            [corpus.feats[i] for i in ok],
            [alignments[i] for i in ok],
            gmm_accs,
            transition_accs,
        )
        avg_loglikes.append(tot / max(gmm_accs.tot_count, 1.0))
        logger.info("pass %d avg log-like/frame: %.4f", it + 1, avg_loglikes[-1])
        old_counts = [am.get_pdf(p).num_gauss for p in range(am.num_pdfs)]
        gmm_est(
            am, gmm_accs, tm, transition_accs,
            MleTransitionUpdateConfig(), MleDiagGmmOptions(),
            mixup=num_gauss, perturb_factor=perturb_factor, rng=rng,
        )
        apply_det_split_perturb(am, old_counts, det_split_perturb, it + 1)
        if f32_storage:
            _round_model_f32(am)
        gauss_sched.append(am.num_gauss)
        if it < max_iter_inc:
            num_gauss += inc_gauss
        if checkpoint_dir is not None:
            save_checkpoint(
                f"{checkpoint_dir}/iter_{it}.ckpt",
                {
                    "iter": it,
                    "transition_model": tm,
                    "tree": tree,
                    "acoustic_model": am,
                    "graphs": graphs,
                    "alignments": alignments,
                    "avg_loglikes": avg_loglikes,
                    "num_gauss_after_est": gauss_sched,
                    "num_gauss": num_gauss,
                    "inc_gauss": inc_gauss,
                    "rng_state": rng.bit_generator.state,
                },
            )

    info = gmm_info(am, tm)
    logger.info("final: %s", info)
    return TrainResult(tm, tree, am, lp, graphs, avg_loglikes,
                       alignments, info, gauss_sched)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (plain versions)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s [%(filename)s:%(lineno)d] %(message)s",
    )
    t0 = time.time()
    lp, corpus = make_synthetic_corpus(num_utts=10)
    result = train_yesno(lp, corpus, num_iters=20, device=device)
    print("avg log-likes:", [round(x, 4) for x in result.avg_loglikes])
    print("final info:", result.info)
    print(f"wall time: {time.time() - t0:.1f}s")
    # learning check: final avg loglike must beat the flat start by a lot
    assert result.avg_loglikes[-1] > result.avg_loglikes[0] + 5.0


if __name__ == "__main__":
    main()
