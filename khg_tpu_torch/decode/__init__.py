from khg_tpu_torch.decode.arpa import arpa_to_fst
from khg_tpu_torch.decode.decoder import FasterDecoder, FasterDecoderOptions
from khg_tpu_torch.decode.graph import build_hclg
from khg_tpu_torch.decode.wer import levenshtein_align, write_error_stats
