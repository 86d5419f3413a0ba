"""The port's durability plane: checkpoint manifests and the POSIX
object store they commit through (stdlib only)."""

from kfac_pytorch_tpu_torch.store.posix import PosixStore  # noqa: F401
