"""Visual SLAM engine in JAX (ORB-SLAM2 capability class).

A JAX/XLA implementation of the capability surface of
`chalmers-revere/opendlv-perception-vision-orbslam2` (an OpenDLV-packaged
ORB-SLAM2 in C++14), re-designed for an accelerator:

- pointer-graph map  ->  fixed-capacity array `MapState` pytrees
- per-keypoint branchy loops  ->  masked batched kernels
- g2o sparse LM  ->  pure-JAX Levenberg-Marquardt with Schur complement
- pthreads        ->  jitted pipeline stages driven by a host scheduler
- mutexes         ->  pure functional state updates

Layout (mirrors SURVEY.md section 7):
  ops/       geometry + image/feature kernels (SE3/Sim3, FAST, rBRIEF, Hamming)
  models/    SLAM pipeline stages (frame, tracking, mapping, loop closing, map)
  optim/     nonlinear least squares (pose LM, bundle adjustment, pose graph)
  parallel/  device-mesh sharding of BA / map storage
  io/        host-side dataset + message I/O (KITTI runner, pose/map dumps)
  utils/     config, synthetic-world fixtures, trajectory metrics
"""

import jax as _jax

# Pose math is fp32 3x3/4x4 algebra; without this, float32 matmuls on the GPU
# may run in TF32 (~10 mantissa bits) and silently degrade SE3/Sim3 accuracy.
# Kernels that *want* bf16 (e.g. the Hamming-as-matmul path) cast explicitly,
# so this is safe globally.
_jax.config.update("jax_default_matmul_precision", "float32")

__version__ = "0.1.0"

