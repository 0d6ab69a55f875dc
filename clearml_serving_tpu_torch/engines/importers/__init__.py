"""Model importers: foreign formats -> servable bundles on torch.

Counterpart of ``clearml_serving_tpu/engines/importers/``:

- onnx_import: stock ``.onnx`` files -> an interpreter over torch ops
  (zero-dependency protobuf parsing in onnx_proto);
- graphdef_import: frozen TF graphs and TF1 SavedModel wrappers, over the
  same parser;
- torchscript_import: ``model.pt`` files, run as they are;
- convert_hf_whisper: a local HF Whisper checkpoint -> a whisper bundle
  (weights, mel filters, prompt and timestamp ids, alignment heads).
"""
