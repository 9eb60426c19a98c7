"""ONNX export and import without the `onnx` package (port of
`herald_tpu/onnx/`): a protobuf codec for the public onnx.proto schema
that streams a large table to the file and maps it back
(`proto.py`), an exporter that traces the tower with `make_fx`
(`export.py`) and a pure-numpy executor (`runtime.py`)."""

from herald_tpu_torch.onnx.export import export_inference, export_state  # noqa
from herald_tpu_torch.onnx.runtime import OnnxModel  # noqa
