"""PyTorch/CUDA port of lidardetection_tpu for one NVIDIA H100.

The JAX package beside this one is the reference. This package imports
torch, numpy and yaml, and nothing of JAX, flax or lidardetection_tpu: the
framework-free pieces it needs (config, voxelizer, synthetic scenes, anchor
grid) are its own copies.

Ported so far: PointPillar, SECOND and PV-RCNN serving
(``serve.Detector``), PointPillar and SECOND training (``train.Trainer``).
All five TPU kernels of the JAX package are hand-written CUDA C++ for
sm_90a under ``csrc/``, built at first use into ``build/``
(``ops/_build.py``).
"""

__version__ = '0.4.0'
