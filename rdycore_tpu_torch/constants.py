"""Physical and numerical constants.

Mirrors the reference RDycore constants:
- GRAVITY: the reference's src/swe/swe_types_petsc.h:7 (9.806 m/s^2)
- default tiny_h / h_anuga / xq2018_threshold: the reference's
  src/yaml_input.c:854-862
"""

GRAVITY = 9.806

DEFAULT_TINY_H = 1.0e-7
DEFAULT_H_ANUGA = 0.0
DEFAULT_XQ2018_THRESHOLD = 1.0e-10

# number of prognostic flow degrees of freedom (h, hu, hv)
N_FLOW_DOF = 3

# maximum number of sediment size classes (reference: CMakeLists.txt:12-21)
MAX_NUM_SEDIMENT_CLASSES = 5
