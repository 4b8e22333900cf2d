"""ONNX without the ``onnx`` package: the protobuf wire codec (:mod:`.proto`,
a copy of the JAX package's), the torch.export -> ONNX converter
(:mod:`.convert`), a runtime on torch tensors (:mod:`.runtime`) and a
minimal KServe v2 endpoint that serves it (:mod:`.kserve`)."""

from . import proto  # noqa: F401
from .convert import UnsupportedOp, to_onnx  # noqa: F401
