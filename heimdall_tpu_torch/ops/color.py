"""Color conversions with OpenCV numeric parity (port of heimdall_tpu/ops/color.py).

OpenCV's uint8 BGR->GRAY path is fixed point: Y = (B*b + G*g + R*r +
2^(S-1)) >> S with BT.601 weights; cv2 5.x uses S=15 (b=3735, g=19235,
r=9798).
"""

import torch

# BT.601 luma weights in Q15 fixed point — matches cv2 5.x exactly.
B_Q15 = 3735   # round(0.114  * 2**15)
G_Q15 = 19235  # round(0.587  * 2**15)
R_Q15 = 9798   # round(0.299  * 2**15)
SHIFT = 15


def gray_from_planes(b: torch.Tensor, g: torch.Tensor,
                     r: torch.Tensor) -> torch.Tensor:
    """Q15 BT.601 luma of three uint8 planes -> uint8 (any shape).

    The planes are widened to int32 first: uint8 arithmetic in torch wraps.
    """
    y = (b.to(torch.int32) * B_Q15 + g.to(torch.int32) * G_Q15
         + r.to(torch.int32) * R_Q15 + (1 << (SHIFT - 1))) >> SHIFT
    return y.to(torch.uint8)


def bgr_to_gray(image: torch.Tensor) -> torch.Tensor:
    """BGR uint8 [..., H, W, 3] -> grayscale uint8 [..., H, W].

    Bit-exact with cv2.cvtColor(img, cv2.COLOR_BGR2GRAY).  Anything without
    a trailing 3-channel axis is returned as is.
    """
    if image.dim() >= 3 and image.shape[-1] == 3:
        return gray_from_planes(image[..., 0], image[..., 1], image[..., 2])
    return image


def gray_to_bgr(image: torch.Tensor) -> torch.Tensor:
    """Grayscale [..., H, W] -> BGR [..., H, W, 3] by channel replication
    (a trailing 3-channel axis is returned as is)."""
    if image.dim() >= 3 and image.shape[-1] == 3:
        return image
    return torch.stack([image, image, image], dim=-1)
