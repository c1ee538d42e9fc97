"""The placement system of the port (paper: dynamic task placement for
edge-cloud serverless), module by module like ``repro.core``:

- ``pricing``, ``perf_models``, ``gbrt``, ``cil``, ``recurrence``,
  ``workload``, ``apps``, ``fit``, ``records``, ``events``, ``faults``,
  ``overload`` — host-side numpy, own copies of the reference modules (the
  twin's numpy RNG streams are what make per-record parity possible);
- ``convert`` — fitted models carried across as plain numpy arrays;
- ``predictor`` — the Predictor; its batched GBRT column runs the CUDA
  ensemble kernel when its ``device`` is a CUDA device;
- ``decision`` — the Decision Engine; ``array_backend="torch"`` routes each
  chunk through ``torch_core``;
- ``torch_core`` — the device placement core: predict -> sequential walk ->
  one verifying replay, over the state-walk, state-replay, linear-scan and
  GBRT kernels, with cross-chunk residency;
- ``runtime`` — ``PlacementRuntime`` and the AWS twin backend; ``serve_stream``
  accepts ``array_backend="torch"`` and ``device=``.
"""
