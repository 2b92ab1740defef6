from .beam_search import beam_search, beam_search_cached
from .transformer import Transformer, TransformerConfig, TransformerTask
from .gnmt import Gnmt, GnmtConfig, GnmtTask
