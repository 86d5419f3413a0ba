"""The port's LM corpus against the JAX LM trainer's
(``examples/longcontext_lm.py``): the synthetic Markov corpus and a
text-file corpus give the same ids, and the window sampler the same
batches.
"""

import argparse
import importlib.util
import os

import numpy as np
import pytest

from kfac_pytorch_tpu_torch import data as tdata

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        'longcontext_lm_example',
        os.path.join(ROOT, 'examples', 'longcontext_lm.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('text', [None, 'a b a c a b d e a b c a b'])
def test_corpus_and_batches_match_the_jax_trainer(tmp_path, text):
    """The synthetic Markov corpus (text None) and a text-file corpus
    (``--data``, vocabulary cut to ``vocab_limit``) give the JAX trainer's
    ids, and the sampler its batches."""
    data = None
    if text is not None:
        data = str(tmp_path / 'corpus.txt')
        with open(data, 'w') as f:
            f.write(' '.join([text] * 4))
    ex = _jax_example()
    args = argparse.Namespace(data=data, vocab_limit=4, synthetic_vocab=40,
                              batch_size=2, seq_len=8, seed=3,
                              steps_per_epoch=4)
    jids, jv = ex.load_corpus(args)
    tids, tv = tdata.load_corpus(data, 4, 40, 2, 8, 3)
    assert tv == jv == (40 if text is None else 4)
    np.testing.assert_array_equal(tids, jids)
    jb = list(ex.sample_batches(jids, args, np.random.RandomState(5)))
    tb = list(tdata.sample_lm_batches(tids, 8, 2, 4,
                                      np.random.RandomState(5)))
    assert len(tb) == len(jb) == 4
    for j, t in zip(jb, tb):
        for k in ('input', 'label'):
            np.testing.assert_array_equal(t[k], np.asarray(j[k]))
