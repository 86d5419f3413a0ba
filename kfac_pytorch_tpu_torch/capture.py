"""Activation / output-gradient capture (port of ``kfac_pytorch_tpu/capture.py``).

The JAX package sows each K-FAC layer's input into a Flax collection and
takes ``g`` as the cotangent of a zero tap added to the layer's output,
bias included. Here the same two tensors come from hooks:

- ``a``: a forward hook on every K-FAC layer of the plan (``nn.Conv2d``/
  ``nn.Linear`` of this package, ``kfac_enabled``) records the layer's
  input;
- ``g``: the same forward hook registers a tensor hook on the layer's
  OUTPUT (``output.register_hook``), which receives ``dL/d output`` — the
  tap cotangent. A module backward hook is not used: it wraps inputs and
  outputs and breaks on in-place ops such as ``ReLU(inplace=True)``.

Conv ``a`` and ``g`` are handed on in the JAX layout, NHWC: the model runs
in ``torch.channels_last``, where the NHWC view of an NCHW tensor is a
free permute. Capture is armed only on factor-update steps
(:class:`Capture` as a context manager); unarmed, the layers are plain
torch layers.

Layer metadata (:class:`LayerMeta`) mirrors the JAX fields, including the
JAX conventions for ``kernel_shape`` (HWIO ``(kh, kw, c_in, c_out)`` for a
conv, ``(d_in, d_out)`` for a dense) and ``name`` (``'/'``-joined module
path), so a plan built here has the JAX plan's slot tables.
"""

import dataclasses
import warnings
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LayerMeta:
    """Static description of one K-FAC layer."""
    name: str                 # '/'.join(path) — the JAX registry key
    path: Tuple[str, ...]     # module path ('layer1_0', 'conv1')
    kind: str                 # 'dense' | 'conv'
    use_bias: bool
    in_dim: int               # true factor-A dim (incl. bias column)
    out_dim: int              # true factor-G dim
    kernel_shape: Tuple[int, ...]   # JAX kernel shape (HWIO / [in, out])
    kernel_size: Optional[Tuple[int, int]] = None   # conv only
    strides: Optional[Tuple[int, int]] = None       # conv only
    padding: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None

    @property
    def grad_shape(self):
        """Matrix-form gradient shape [out_dim, in_dim] (bias col included)."""
        return (self.out_dim, self.in_dim)

    @property
    def module_name(self):
        """The torch module name (``'.'``-joined path)."""
        return '.'.join(self.path)


def canonical_padding(in_size, kernel_size, strides, padding):
    """Resolve a padding spec ('SAME', 'VALID', ``(ph, pw)`` or
    ``((lo, hi), (lo, hi))``) to explicit per-dim ``(lo, hi)`` pairs with
    ``lax`` semantics (SAME puts the odd pixel at the high end)."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == 'VALID':
            return ((0, 0), (0, 0))
        if p == 'SAME':
            out = []
            for s, k, st in zip(in_size, kernel_size, strides):
                o = -(-s // st)
                total = max((o - 1) * st + k - s, 0)
                out.append((total // 2, total - total // 2))
            return tuple(out)
        raise ValueError(f'unsupported padding {padding!r}')
    out = []
    for p in padding:
        if isinstance(p, (tuple, list)):
            out.append((int(p[0]), int(p[1])))
        else:
            out.append((int(p), int(p)))
    return tuple(out)


def layer_meta(name, module):
    """:class:`LayerMeta` of one K-FAC layer (a ``kfac_pytorch_tpu_torch.nn``
    ``Conv2d`` or ``Linear``) at module path ``name`` (torch dotted)."""
    path = tuple(name.split('.'))
    use_bias = module.bias is not None
    if isinstance(module, torch.nn.Conv2d):
        cout, cin, kh, kw = module.weight.shape
        if isinstance(module.padding, str) or module.groups != 1 \
                or tuple(module.dilation) != (1, 1):
            raise ValueError(f'{name}: K-FAC conv capture takes explicit '
                             'padding, groups=1 and no dilation')
        ph, pw = module.padding
        return LayerMeta(
            name='/'.join(path), path=path, kind='conv', use_bias=use_bias,
            in_dim=kh * kw * cin + int(use_bias), out_dim=cout,
            kernel_shape=(kh, kw, cin, cout), kernel_size=(kh, kw),
            strides=tuple(module.stride), padding=((ph, ph), (pw, pw)))
    if isinstance(module, torch.nn.Linear):
        return LayerMeta(
            name='/'.join(path), path=path, kind='dense', use_bias=use_bias,
            in_dim=module.in_features + int(use_bias),
            out_dim=module.out_features,
            kernel_shape=(module.in_features, module.out_features))
    raise TypeError(f'{name}: not a K-FAC layer ({type(module).__name__})')


def kfac_layers(model):
    """``(name, module)`` of every K-FAC-enabled layer, registration order."""
    return [(name, m) for name, m in model.named_modules()
            if getattr(m, 'kfac_enabled', False)]


def collect_layer_meta(model, sample_input, exclude_vocabulary_size=None):
    """Discover K-FAC layers by running one forward on ``sample_input``
    (the model's own input: an NCHW image batch, ``[B, L]`` tokens; no
    grad, eval mode, so no state changes). Returns ``{name: LayerMeta}`` in
    CALL order, like the JAX trace-time registry. ``exclude_vocabulary_size``
    drops the pre-softmax head (:func:`filter_vocab_head`)."""
    order = []
    handles = [m.register_forward_hook(
        lambda mod, inp, out, name=name: order.append((name, mod)))
        for name, m in kfac_layers(model)]
    was_training = model.training
    try:
        model.eval()
        with torch.no_grad():
            model(sample_input)
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    metas = {}
    for name, mod in order:
        meta = layer_meta(name, mod)
        metas.setdefault(meta.name, meta)
    if exclude_vocabulary_size is not None:
        metas = filter_vocab_head(metas, exclude_vocabulary_size)
    return metas


def filter_vocab_head(metas, vocab_size):
    """Drop the pre-softmax head: the FINAL captured layer, iff it is a
    dense with ``out_dim == vocab_size``. Other dense layers that merely
    share the dim are kept, with a warning (the JAX package's rule; the
    reference's match at any position would drop them silently)."""
    names = list(metas)
    drop = set()
    if names:
        last = metas[names[-1]]
        if last.kind == 'dense' and last.out_dim == vocab_size:
            drop.add(names[-1])
    interior = [k for k in names if k not in drop
                and metas[k].kind == 'dense'
                and metas[k].out_dim == vocab_size]
    if interior:
        warnings.warn(
            f'layers {interior} match exclude_vocabulary_size={vocab_size} '
            'but are not the trailing pre-softmax head — keeping them '
            'preconditioned', stacklevel=2)
    return {k: m for k, m in metas.items() if k not in drop}


def _nhwc(t):
    """NCHW (channels_last in memory) -> the NHWC view; dense passes."""
    return t.permute(0, 2, 3, 1) if t.ndim == 4 else t


def _stacked(calls):
    """One layer's captures: the tensor of its one call as it is, or the
    calls stacked along a new leading axis (time, for a recurrent cell)."""
    return calls[0] if len(calls) == 1 else torch.stack(calls)


class Capture:
    """Arm capture on the K-FAC layers ``metas`` (the plan's) of ``model``
    for one forward and backward: ``with Capture(model, plan.metas) as
    cap: loss.backward()`` leaves ``cap.acts`` and ``cap.gs`` as ``{meta
    name: tensor}`` (NHWC for convs). Layers outside the plan, such as an
    excluded vocabulary head, are not hooked and keep nothing. Hooks are
    removed on exit. :meth:`regrad`, inside the block, takes ``g`` again
    from a second loss of the same forward.

    A layer called more than once in the forward (a recurrent cell's
    projections, once a timestep) has its calls stacked along a new
    leading axis, ``[T, B, ...]``: the layout of the JAX package's
    ``nn.scan`` over a capturing cell (``variable_axes`` 0 on the sown
    inputs and taps), whose factor statistics average the batch axis and
    count time as the ``n`` of ``compute_a_dense``/``compute_g_dense``. A
    layer called once keeps its tensor as it is."""

    def __init__(self, model, metas):
        self.model = model
        self.metas = list(metas)
        # {name: one entry a call}, in call order
        self._acts = {}
        self._gs = {}
        self._outs = {}
        self._handles = []

    @property
    def acts(self):
        """``{name: a}``, each layer's calls stacked (:func:`_stacked`)."""
        return {k: _stacked(v) for k, v in self._acts.items()}

    @property
    def gs(self):
        """``{name: g}``, each layer's calls stacked; a layer whose output
        took no gradient has no entry."""
        return {k: _stacked(v) for k, v in self._gs.items()
                if all(t is not None for t in v)}

    def __enter__(self):
        modules = dict(self.model.named_modules())
        for meta in self.metas:
            mod = modules[meta.module_name]
            self._handles.append(mod.register_forward_hook(
                lambda m, inp, out, key=meta.name: self._on_forward(
                    key, inp, out)))
        return self

    def _on_forward(self, key, inp, out):
        self._acts.setdefault(key, []).append(_nhwc(inp[0].detach()))
        if out.requires_grad:
            self._outs.setdefault(key, []).append(out)
            calls = self._gs.setdefault(key, [])
            calls.append(None)
            def save_g(grad, calls=calls, i=len(calls) - 1):
                calls[i] = _nhwc(grad)
            out.register_hook(save_g)

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        self._handles = []
        # the outputs' gradient hooks hold this object: keeping the
        # outputs past the block would make a cycle that pins them (and
        # their memory) until the garbage collector runs
        self._outs = {}
        return False

    def regrad(self, loss):
        """Replace ``gs`` with ``d loss / d output`` of every captured
        layer: a backward of ``loss``, a second loss on the outputs of the
        captured forward (whose graph the first backward retained), that
        computes the layers' output gradients only: no parameter gradient
        is formed or accumulated. The F1mc Fisher's recapture; ``acts``
        stay the forward's."""
        outs = [(k, o) for k, calls in self._outs.items() for o in calls]
        grads = torch.autograd.grad(loss, [o for _, o in outs],
                                    allow_unused=True)
        self._gs = {k: [] for k in self._outs}
        for (key, o), g in zip(outs, grads):
            self._gs[key].append(_nhwc(torch.zeros_like(o) if g is None
                                       else g))


def tensor_leaves(tree):
    """The tensors of a tree of dicts, lists and tuples (None skipped)."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in tensor_leaves(sub)]
    return []


def all_finite(*trees):
    """0-d bool tensor: every floating leaf of every tree is finite (the
    health guard's batch screen; integer leaves are finite by definition,
    and no leaves at all is healthy). The leaves of one dtype and device
    are screened together, in a few launches and host calls however many
    there are: ``x * 0`` is 0 where ``x`` is finite and NaN where it is
    not, so the sum of ``|x * 0|`` (``torch._foreach_norm``, ord 1) is
    finite exactly when every entry is (no overflow, unlike a norm of
    ``x`` itself)."""
    groups = {}
    for leaf in tensor_leaves(trees):
        if leaf.is_floating_point():
            groups.setdefault((leaf.dtype, leaf.device), []).append(leaf)
    ok = None
    for leaves in groups.values():
        sums = torch._foreach_norm(torch._foreach_mul(leaves, 0.0), 1)
        part = torch.isfinite(torch.stack(sums)).all()
        ok = part if ok is None else ok & part
    return torch.ones((), dtype=torch.bool) if ok is None else ok


def layer_act(acts, meta: LayerMeta):
    """Layer ``meta``'s captured input (NHWC for a conv)."""
    return acts[meta.name]


def layer_g(gs, meta: LayerMeta):
    """Layer ``meta``'s captured output-gradient (NHWC for a conv)."""
    return gs[meta.name]


#: autograd node names of torch's differentiable collectives
#: (``torch.distributed.nn.functional``)
_COLLECTIVE_NODES = frozenset(
    f'_{n}Backward' for n in ('AllGather', 'AllGatherBase', 'AllReduce',
                              'AlltoAll', 'AlltoAllSingle', 'Broadcast',
                              'Gather', 'Reduce', 'Reduce_Scatter',
                              'Scatter'))
#: how many autograd steps back from the loss the guard looks
_GUARD_DEPTH = 4


def check_local_mean_loss(loss, batch, group):
    """The LOCAL-mean loss convention guard: the loss fed to the capture
    backward must be the mean over this rank's shard only, or every G
    factor scales with the world size. The JAX guard reads shard_map's
    varying-axes types, which torch has no counterpart of; here, on a
    group (``group`` not None), a loss whose last few autograd steps
    include a differentiable collective (``torch.distributed.nn``: the
    loss was reduced over the world before the backward) raises
    ValueError. Average the GRADIENTS over the world instead
    (``collectives.average_grads``). A loss scaled by hand (``* world``)
    cannot be seen. ``batch`` is kept for the JAX signature."""
    del batch
    if group is None or loss.grad_fn is None:
        return
    frontier, seen = [loss.grad_fn], set()
    for _ in range(_GUARD_DEPTH):
        nxt = []
        for node in frontier:
            if node is None or node in seen:
                continue
            seen.add(node)
            name = type(node).__name__
            if name in _COLLECTIVE_NODES:
                raise ValueError(
                    'K-FAC capture loss convention violation: the loss '
                    f'went through a collective ({name}) before the '
                    'capture backward. The convention is the LOCAL-mean '
                    'loss (mean over this rank\'s shard only); average the '
                    'gradients over the K-FAC world instead '
                    '(parallel.collectives.average_grads).')
            nxt.extend(fn for fn, _ in node.next_functions)
        frontier = nxt
