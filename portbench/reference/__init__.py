"""The plain reference of the benchmark: pixelNeRF's mathematics in plain
PyTorch and NumPy, float32 with TF32 off unless a control asks for less. It
imports nothing of ``pixelnerf_tpu_torch``, ``pixelnerf_tpu`` or JAX, and
takes nothing the program made: it reads the benchmark's weights, images,
poses, draws and PNG files itself."""
