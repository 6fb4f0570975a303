"""Lang-directory preparation: the prepare_lang entry point.

Writes the standard lang artifacts (phones.txt, words.txt, topo,
L.fst / L_disambig.fst in OpenFST text form) from a lexicon.txt, mirroring
the reference's prepare_lang script outputs
(reference scripts/prepare_lang.py:603-616 and the files listed in
its module docstring).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from khg_tpu_torch.lang.lexicon import Lexicon, Lexiconp
from khg_tpu_torch.lang.lfst import make_lexicon_fst_with_silence
from khg_tpu_torch.lang.topo import generate_hmm_topo


def prepare_lang(
    lang_dir: Path,
    lexicon_txt: Optional[Path] = None,
    word2phones: Optional[dict] = None,
    sil_phone: str = "SIL",
    sil_prob: float = 0.5,
    num_sil_states: int = 5,
    num_nonsil_states: int = 3,
):
    """Build and write the lang directory; returns (lexiconp_disambig, topo).

    Files written: phones.txt, words.txt, topo, L.fst.txt,
    L_disambig.fst.txt, phones/disambig.txt.
    """
    lang_dir = Path(lang_dir)
    lang_dir.mkdir(parents=True, exist_ok=True)
    (lang_dir / "phones").mkdir(exist_ok=True)

    if word2phones is not None:
        lexicon = Lexicon(word2phones=word2phones)
    else:
        lexicon = Lexicon(lexicon_txt=str(lexicon_txt))
    lexiconp = Lexiconp.from_lexicon(lexicon)
    lp = lexiconp.add_lex_disambig()

    with open(lang_dir / "phones.txt", "w", encoding="utf-8") as f:
        for p, i in lp.phone2id.items():
            f.write(f"{p} {i}\n")
    with open(lang_dir / "words.txt", "w", encoding="utf-8") as f:
        for w, i in lp.word2id.items():
            f.write(f"{w} {i}\n")
    with open(lang_dir / "phones" / "disambig.txt", "w", encoding="utf-8") as f:
        for i in range(lp.max_disambig + 1):
            f.write(f"#{i}\n")

    topo = generate_hmm_topo(
        non_sil_phones=lp.get_non_sil_phone_ids(sil_phone),
        sil_phone=lp.get_sil_phone_id(sil_phone),
        num_non_sil_states=num_nonsil_states,
        num_sil_states=num_sil_states,
    )
    with open(lang_dir / "topo", "w", encoding="utf-8") as f:
        f.write(topo.write())

    L = make_lexicon_fst_with_silence(
        lexiconp=lexiconp, sil_prob=sil_prob, sil_phone=sil_phone
    )
    with open(lang_dir / "L.fst.txt", "w", encoding="utf-8") as f:
        f.write(L.text())
    L_disambig = make_lexicon_fst_with_silence(
        lexiconp=lp, sil_prob=sil_prob, sil_phone=sil_phone
    )
    with open(lang_dir / "L_disambig.fst.txt", "w", encoding="utf-8") as f:
        f.write(L_disambig.text())
    return lp, topo
