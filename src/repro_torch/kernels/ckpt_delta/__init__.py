from repro_torch.kernels.ckpt_delta.ops import (delta_decode, delta_encode,
                                                flat_int8_encode,
                                                flat_lossless_encode,
                                                int8_encode_leaf,
                                                launch_counts,
                                                lossless_decode,
                                                lossless_encode,
                                                lossless_encode_leaf,
                                                pack_flat,
                                                reset_launch_counts)

__all__ = ["pack_flat", "flat_lossless_encode", "flat_int8_encode",
           "lossless_decode", "delta_decode", "lossless_encode",
           "delta_encode", "lossless_encode_leaf", "int8_encode_leaf",
           "launch_counts", "reset_launch_counts"]
