"""yolov5_tpu_torch — the PyTorch / CUDA port of yolov5_tpu.

The JAX package ``yolov5_tpu`` is the reference this package is held against
in ``tests/test_torch_*.py``. This package imports ``torch`` and never JAX:
host code it needs is carried over as small copies, each tested equal to its
original, and the YAML model configs are read by path from
``yolov5_tpu/models/configs``.

Subpackages
-----------
- ``ops``    — box math, NMS (greedy suppression kernel K1), stem conv (K2),
  the folded convs' epilogue (K3), mask ops and the outer-border follower
- ``models`` — canonical yolov5 layers, the Segment head, YAML graph, weight
  conversion
- ``native`` — the JPEG batch decoder (libjpeg, OpenMP; built by g++ at
  first use) under the loader's square JPEG batches
- ``data``   — letterbox, image files (BMP without OpenCV), inference
  sources, the dataset and loader, augmentation on the device, the
  device-resident training set
- ``infer``  — ``Detector`` (uint8 batch in, padded ``Detections`` out;
  decoded and TTA forwards; the exported backends: ``.onnx``, OpenCV DNN,
  KServe v2, TF exports), ``Ensemble``, annotation,
  ``run`` (the detect loop); ``infer_segment`` — segmentation predict
- ``export`` — ``python -m yolov5_tpu_torch.export``: the fused ``.ckpt``,
  the ``torch.export`` program (``.pt2``), ``.onnx`` and the TensorFlow
  formats (saved_model, pb, tflite, int8 tflite); ``onnx`` — the wire
  codec, the torch.export -> ONNX converter, a runtime on torch tensors and
  the ONNX -> TF lowering (``to_tf``);
  ``remote`` — the REST and KServe v2 clients
- ``detect``, ``segment``, ``serve`` — the detect CLI, the segmentation CLI
  (``predict``), the HTTP service; ``hub``, ``results`` — model loading and
  end-user results
- ``eval``   — metrics, COCO scoring, the validation loop
- ``train``  — assignment, loss, optimizer and EMA, the train step, the
  training loop and its CLI, ``python -m yolov5_tpu_torch.train``, hyp
  evolution and the HPO sweep (``hpo``, CLI ``python -m yolov5_tpu_torch.hpo``)
- ``parallel`` — several ranks under torchrun: the process group, the
  replicated state, the summed gradient, the global batch's rows
- ``utils``  — run directories, dataset configs, ``.ckpt`` reading and
  writing, hyperparameters, callbacks, the loggers (CSV, TensorBoard, W&B,
  ClearML, Comet), the plots, autoanchor, URL fetching, the label font,
  profiling (``profile``) and ``autobatch``
- ``val``    — the validation CLI, ``python -m yolov5_tpu_torch.val``

The CUDA kernels under ``csrc/`` are built by ``_build.py`` at first use on a
CUDA tensor; importing the package builds and loads nothing.
"""

__version__ = "0.1.0"
