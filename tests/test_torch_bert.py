"""reftr_torch BERT against reftr_tpu (tiny config, float32, CPU).

Tolerance: atol 1e-5 (LayerNorm and matmul sums in another order).
"""

import numpy as np
import pytest
import torch

from reftr_tpu.core.config import BertConfig as JaxBertConfig
from reftr_tpu.nn.bert import BertModel as JaxBertModel
from reftr_torch.core.config import BertConfig
from reftr_torch.nn.bert import BertModel
from torch_parity_utils import close, load_port, random_flax_params, t

ATOL = 1e-5


@pytest.mark.parametrize("with_mask", [True, False])
def test_bert_matches_jax(with_mask):
    rng = np.random.default_rng(0)
    b, s = 3, 12
    ids = rng.integers(1, 512, size=(b, s)).astype(np.int32)
    mask = np.zeros((b, s), np.int32)
    for i, n in enumerate((12, 7, 3)):
        mask[i, :n] = 1
    args = (ids, mask) if with_mask else (ids,)
    jbert = JaxBertModel(JaxBertConfig.tiny())
    params = random_flax_params(jbert, *args)
    want_seq, want_pooled = jbert.apply({"params": params}, *args)
    port = load_port(BertModel(BertConfig.tiny()), params)
    with torch.no_grad():
        seq, pooled = port(t(ids).long(), t(mask) if with_mask else None)
    close(seq, want_seq, ATOL)
    close(pooled, want_pooled, ATOL)
