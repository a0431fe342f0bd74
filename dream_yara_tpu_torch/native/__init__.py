"""Native (C++) components, loaded via ctypes.

Build all native libs with:  python -m dream_yara_tpu_torch.native.build
They are also auto-built on first use (into dream_yara_tpu_torch/build/native/).
"""
