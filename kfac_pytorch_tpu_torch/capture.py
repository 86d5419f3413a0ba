"""Activation / output-gradient capture (port of ``kfac_pytorch_tpu/capture.py``).

The JAX package sows each K-FAC layer's input into a Flax collection and
takes ``g`` as the cotangent of a zero tap added to the layer's output,
bias included. Here the same two tensors come from hooks:

- ``a``: a forward hook on every K-FAC layer (``nn.Conv2d``/``nn.Linear``
  of this package, ``kfac_enabled``) records the layer's input;
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


def collect_layer_meta(model, sample_input):
    """Discover K-FAC layers by running one forward on ``sample_input``
    (no grad, eval mode, so no state changes). Returns ``{name: LayerMeta}``
    in CALL order, like the JAX trace-time registry."""
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
    return metas


def _nhwc(t):
    """NCHW (channels_last in memory) -> the NHWC view; dense passes."""
    return t.permute(0, 2, 3, 1) if t.ndim == 4 else t


class Capture:
    """Arm capture on every K-FAC layer of ``model`` for one forward and
    backward: ``with Capture(model) as cap: loss.backward()`` leaves
    ``cap.acts`` and ``cap.gs`` as ``{meta name: tensor}`` (NHWC for
    convs). Hooks are removed on exit."""

    def __init__(self, model):
        self.model = model
        self.acts = {}
        self.gs = {}
        self._handles = []

    def __enter__(self):
        for name, mod in kfac_layers(self.model):
            key = '/'.join(name.split('.'))
            self._handles.append(mod.register_forward_hook(
                lambda m, inp, out, key=key: self._on_forward(key, inp, out)))
        return self

    def _on_forward(self, key, inp, out):
        self.acts[key] = _nhwc(inp[0].detach())
        if out.requires_grad:
            def save_g(grad, key=key):
                self.gs[key] = _nhwc(grad)
            out.register_hook(save_g)

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        self._handles = []
        return False


def layer_act(acts, meta: LayerMeta):
    """Layer ``meta``'s captured input (NHWC for a conv)."""
    return acts[meta.name]


def layer_g(gs, meta: LayerMeta):
    """Layer ``meta``'s captured output-gradient (NHWC for a conv)."""
    return gs[meta.name]


def check_local_mean_loss(loss, batch, axis_name):
    """The local-mean loss convention guard. The JAX guard reads
    shard_map's varying-axes types; at world=1 (``axis_name=None``) there
    is nothing to check, and world>1 is not ported yet."""
    if axis_name is None:
        return
    raise NotImplementedError('world>1 capture (the loss-convention guard '
                              'over a process group) is port slice B')
