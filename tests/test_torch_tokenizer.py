"""The port's hash tokenizer gives the JAX package's ids exactly."""

import numpy as np
import pytest

from outline_rag_tpu.models import tokenizer as jt
from outline_rag_tpu_torch.models import tokenizer as pt

TEXTS = [
    "the alpha wolf leads the pack through the snowy forest",
    "",
    "gamma radiation is measured with a geiger counter " * 12,
    "Ünïcode wörds and   extra   spaces",
]


@pytest.mark.parametrize("max_len", [8, 64, 512])
def test_hash_tokenizer_batch_ids_equal(max_len):
    jb = jt.HashTokenizer(vocab_size=250_002).batch(TEXTS, max_len)
    pb = pt.HashTokenizer(vocab_size=250_002).batch(TEXTS, max_len)
    np.testing.assert_array_equal(pb.input_ids, jb.input_ids)
    np.testing.assert_array_equal(pb.attention_mask, jb.attention_mask)
    assert pb.input_ids.dtype == jb.input_ids.dtype == np.int32


def test_hash_tokenizer_pairs_ids_equal():
    queries = ["wolf pack"] * 3 + ["geiger"]
    jb = jt.HashTokenizer(1024).batch_pairs(queries, TEXTS, 128, (64, 128))
    pb = pt.HashTokenizer(1024).batch_pairs(queries, TEXTS, 128, (64, 128))
    np.testing.assert_array_equal(pb.input_ids, jb.input_ids)
    np.testing.assert_array_equal(pb.attention_mask, jb.attention_mask)


def test_bucket_ladders_equal():
    assert pt.DEFAULT_BUCKETS == jt.DEFAULT_BUCKETS
    assert pt.LONG_BUCKETS == jt.LONG_BUCKETS
    for n in (1, 32, 33, 513, 9000):
        assert pt.pick_bucket(n) == jt.pick_bucket(n)
        assert pt.buckets_for(n) == jt.buckets_for(n)
