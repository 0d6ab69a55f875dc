"""Model importers: foreign formats -> servable bundles on torch.

Counterpart of ``clearml_serving_tpu/engines/importers/`` (without its
Whisper converter, which waits for the Whisper engine):

- onnx_import: stock ``.onnx`` files -> an interpreter over torch ops
  (zero-dependency protobuf parsing in onnx_proto);
- graphdef_import: frozen TF graphs and TF1 SavedModel wrappers, over the
  same parser;
- torchscript_import: ``model.pt`` files, run as they are.
"""
