# Hand-written CUDA kernels of the meta phase (csrc/meta_kernels.cu), each
# with its plain PyTorch version beside it; ops.py dispatches by device.
