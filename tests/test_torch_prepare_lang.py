"""The port's prepare_lang (khg_tpu_torch/lang/prepare.py) writes the
same lang directory as khg_tpu's, byte for byte, for the yesno lexicon,
the char-level digit lexicon, a lexicon.txt and other state counts."""

import filecmp

import pytest

from khg_tpu.lang.prepare import prepare_lang as j_prepare
from khg_tpu.recipes.audiomnist import digits_lexicon
from khg_tpu_torch.lang.prepare import prepare_lang as t_prepare

FILES = ("phones.txt", "words.txt", "topo", "L.fst.txt", "L_disambig.fst.txt",
         "phones/disambig.txt")

CASES = {
    "yesno": dict(word2phones={"<SIL>": ["SIL"], "YES": ["Y"], "NO": ["N"]}),
    "digits": dict(word2phones=digits_lexicon()),
    "states-2-4": dict(word2phones={"<SIL>": ["SIL"], "YES": ["Y"], "NO": ["N"]},
                       num_sil_states=2, num_nonsil_states=4, sil_prob=0.3),
}


@pytest.mark.parametrize("case", list(CASES) + ["lexicon.txt"])
def test_lang_dir_byte_equal(tmp_path, case):
    if case == "lexicon.txt":
        lex = tmp_path / "lexicon.txt"
        lex.write_text("<SIL> SIL\nYES Y EH S\nNO N OW\nNOT N OW T\n")
        kw = dict(lexicon_txt=lex)
    else:
        kw = CASES[case]
    lp_j, topo_j = j_prepare(tmp_path / "jax", **kw)
    lp_t, topo_t = t_prepare(tmp_path / "port", **kw)
    for name in FILES:
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name,
                           shallow=False), name
    assert lp_t.word2id == lp_j.word2id and lp_t.phone2id == lp_j.phone2id
    assert topo_t.write() == topo_j.write()
