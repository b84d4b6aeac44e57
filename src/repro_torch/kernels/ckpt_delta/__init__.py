from repro_torch.kernels.ckpt_delta.ops import (delta_decode,
                                                flat_int8_encode,
                                                flat_lossless_encode,
                                                launch_counts,
                                                lossless_decode, pack_flat,
                                                reset_launch_counts)

__all__ = ["pack_flat", "flat_lossless_encode", "flat_int8_encode",
           "lossless_decode", "delta_decode", "launch_counts",
           "reset_launch_counts"]
