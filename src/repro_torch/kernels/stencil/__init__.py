from .ops import (GAUSS3, SHARPEN3, SOBEL_X3, SOBEL_Y3, gaussian_blur,
                  sharpen, sobel_mag2, stencil3x3, stencil3x3_ref)

__all__ = ["stencil3x3", "stencil3x3_ref", "gaussian_blur", "sharpen",
           "sobel_mag2", "GAUSS3", "SHARPEN3", "SOBEL_X3", "SOBEL_Y3"]
