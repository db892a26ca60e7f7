"""Optional BERT text conditioning (port of extdm_tpu/models/dm/text.py):
``tokenize`` and ``bert_embed`` through ``transformers``' BertTokenizer and
BertModel, the CLS token's hidden state or the attention-masked mean over
tokens (768 wide), as tensors on the tokens' device. No trained config
uses it (``use_bert_text_cond`` is False); its output feeds the guidance's
``cond=`` (``cond_dim``).

``transformers`` is imported where it is used; without it the call raises
an ImportError naming it. One deliberate difference from the JAX package:
the pretrained ``bert-base-cased`` weights are not in the repository and
nothing is downloaded, so ``model_dir`` (a local directory that
``from_pretrained`` reads: config, weights, vocab) is required and its
absence raises ValueError, where the JAX package fetches the weights by
name.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Optional

import torch

BERT_MODEL_DIM = 768
MAX_LENGTH = 256


@lru_cache(maxsize=1)
def _load(model_dir: Optional[str]):
    if not model_dir:
        raise ValueError("text conditioning needs model_dir: a local directory with the "
                         "pretrained bert-base-cased weights, config and vocab (they are not in "
                         "the repository, and nothing is downloaded)")
    try:
        from transformers import BertModel, BertTokenizer
    except ImportError as e:
        raise ImportError("text conditioning needs the transformers package "
                          "(BertTokenizer, BertModel), which is not installed") from e
    tokenizer = BertTokenizer.from_pretrained(model_dir, local_files_only=True)
    model = BertModel.from_pretrained(model_dir, local_files_only=True)
    return tokenizer, model.eval()


def tokenize(texts: List[str], model_dir: Optional[str] = None):
    """Texts -> the tokenizer's batch ("input_ids", "attention_mask", ...), each
    (B, 256) on the CPU, padded and truncated to MAX_LENGTH."""
    tokenizer, _ = _load(model_dir)
    return tokenizer(texts, padding="max_length", truncation=True, max_length=MAX_LENGTH,
                     return_tensors="pt")


@torch.no_grad()
def bert_embed(token_batch, return_cls_repr: bool = False,
               model_dir: Optional[str] = None) -> torch.Tensor:
    """(B, L) tokens -> (B, 768): the CLS token's hidden state, or the mean of
    the hidden states over the attention mask. Runs on the tokens' device."""
    _, model = _load(model_dir)
    ids, mask = token_batch["input_ids"], token_batch["attention_mask"]
    model.to(ids.device)
    hidden = model(input_ids=ids, attention_mask=mask).last_hidden_state  # (B, L, 768)
    if return_cls_repr:
        return hidden[:, 0]
    mask = mask[..., None].float()
    return (hidden * mask).sum(1) / mask.sum(1).clamp(min=1)
