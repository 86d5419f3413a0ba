"""Autoregressive decoding (greedy and beam search) and corpus BLEU (port
of ``kfac_pytorch_tpu/models/translator.py``).

Both decoders run the model in eval mode without gradients, over the
JAX decoders' fixed ``[B, max_len + 1]`` token buffer (bos at position
0, pad after), so a step sees the same masks and picks the same tokens.
"""

import collections
import math

import numpy as np
import torch


@torch.no_grad()
def greedy_decode(model, src_seq, bos_idx, eos_idx, max_len=64):
    """Greedy decode of ``src_seq`` ``[B, L]`` with the
    ``models.transformer.Transformer`` ``model``: ``[B, max_len]`` token
    ids (bos excluded), pad after each sentence's eos."""
    was_training = model.training
    model.eval()
    try:
        B = src_seq.shape[0]
        src_mask = model.src_mask(src_seq)
        enc_out = model.encode(src_seq, src_mask)
        tokens = torch.full((B, max_len + 1), model.trg_pad_idx,
                            dtype=torch.int64, device=src_seq.device)
        tokens[:, 0] = bos_idx
        done = torch.zeros(B, dtype=torch.bool, device=src_seq.device)
        for i in range(max_len):
            dec = model.decode(tokens, enc_out, model.trg_mask(tokens),
                               src_mask)
            nxt = torch.argmax(model.project(dec)[:, i], dim=-1)
            nxt = torch.where(done, torch.full_like(nxt, model.trg_pad_idx),
                              nxt)
            done = done | (nxt == eos_idx)
            tokens[:, i + 1] = nxt
        return tokens[:, 1:]
    finally:
        model.train(was_training)


@torch.no_grad()
def beam_search_decode(model, src_seq, bos_idx, eos_idx, beam_size=5,
                       max_len=64, alpha=0.7):
    """Beam search with the length penalty ``((5 + len) / 6) ** alpha``
    (the reference ``Translator``'s defaults), one source sentence
    (``[L]`` or ``[1, L]``) at a time: the best hypothesis as a list of
    token ids."""
    was_training = model.training
    model.eval()
    try:
        if src_seq.ndim == 1:
            src_seq = src_seq[None]
        dev = src_seq.device
        src_mask = model.src_mask(src_seq)
        enc_out = model.encode(src_seq, src_mask).repeat_interleave(
            beam_size, dim=0)
        src_mask_b = src_mask.repeat_interleave(beam_size, dim=0)
        tokens = np.full((beam_size, max_len + 1), model.trg_pad_idx,
                         np.int32)
        tokens[:, 0] = bos_idx
        scores = np.full(beam_size, -1e9)
        scores[0] = 0.0
        finished = []
        for i in range(max_len):
            t = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
            dec = model.decode(t, enc_out, model.trg_mask(t), src_mask_b)
            logits = model.project(dec)[:, i]
            logp = torch.log_softmax(logits, dim=-1).cpu().numpy()
            cand = scores[:, None] + logp
            flat = cand.ravel()
            top = np.argsort(-flat)[:beam_size * 2]
            new_tokens, new_scores = [], []
            for j in top:
                b, v = divmod(int(j), logp.shape[-1])
                seq = tokens[b].copy()
                seq[i + 1] = v
                if v == eos_idx:
                    lp = ((5 + i + 1) / 6.0) ** alpha
                    finished.append((flat[j] / lp, seq[1:i + 2].tolist()))
                else:
                    new_tokens.append(seq)
                    new_scores.append(flat[j])
                if len(new_tokens) == beam_size:
                    break
            if not new_tokens:
                break
            tokens = np.stack(new_tokens)
            scores = np.asarray(new_scores)
        if not finished:
            finished = [(scores[0], tokens[0, 1:].tolist())]
        finished.sort(key=lambda x: -x[0])
        return finished[0][1]
    finally:
        model.train(was_training)


def bleu(hypotheses, references, max_n=4):
    """Corpus BLEU with uniform n-gram weights and the brevity penalty,
    on lists of token lists (the reference's Multi-30k metric)."""
    log_precisions = []
    hyp_len = sum(len(h) for h in hypotheses)
    ref_len = sum(len(r) for r in references)
    for n in range(1, max_n + 1):
        match, total = 0, 0
        for hyp, ref in zip(hypotheses, references):
            hgrams = collections.Counter(
                tuple(hyp[i:i + n]) for i in range(len(hyp) - n + 1))
            rgrams = collections.Counter(
                tuple(ref[i:i + n]) for i in range(len(ref) - n + 1))
            match += sum(min(c, rgrams[g]) for g, c in hgrams.items())
            total += max(sum(hgrams.values()), 0)
        if total == 0 or match == 0:
            return 0.0
        log_precisions.append(math.log(match / total))
    bp = (1.0 if hyp_len > ref_len
          else math.exp(1 - ref_len / max(hyp_len, 1)))
    return bp * math.exp(sum(log_precisions) / max_n) * 100.0
