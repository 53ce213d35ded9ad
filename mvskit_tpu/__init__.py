"""mvskit_tpu — a JAX PatchMatch multi-view stereo engine.

Brand-new JAX/XLA implementation of the PM-MVS pipeline
(capability reference: imkaywu/MVSKit): camera/projection model, image
pyramids, NCC photo-consistency, scene-space PatchMatch propagation,
batched refinement, geometric filtering, and PLY/patch I/O — designed
for SPMD execution over accelerator device meshes.
"""

from .config import MVSConfig

__version__ = "0.1.0"
__all__ = ["MVSConfig"]
