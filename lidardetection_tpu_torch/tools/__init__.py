"""The port's tools, each run as ``python -m lidardetection_tpu_torch.tools.
<name>``: ``test`` (one checkpoint, or ``--eval_all`` over a checkpoint
directory), ``demo``, ``inference`` (with the Kalman tracker),
``inference_video``, ``mot_benchmark``, ``inference_bag2json``,
``demo_3d --offscreen`` and ``verify_cuda`` (the kernels against their
plain versions on the card). Each takes the JAX tool's arguments and runs
on the card unless given ``--cpu``.
"""
