"""Text: the CLIP BPE tokenizer (native merge loop, ``native/``) and A1111
prompt emphasis (``text/emphasis.py``)."""
from flexdiffuse_tpu_torch.text.tokenizer import CLIPTokenizer, FakeTokenizer

__all__ = ["CLIPTokenizer", "FakeTokenizer"]
