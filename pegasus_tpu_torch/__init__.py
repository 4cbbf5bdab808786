"""PyTorch/CUDA port of pegasus_tpu for one NVIDIA H100.

Same layout and module names as pegasus_tpu; the device work runs as
torch tensors on an explicit device, and the scan predicate runs as a
hand-written CUDA kernel (csrc/scan_predicate.cu) on the card.
"""

__version__ = "0.1.0"
