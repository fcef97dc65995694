"""CRUSH placement: the port's copy of ``ceph_tpu/crush/``.

``map`` (buckets, rules, tunables, choose_args), ``hashing`` and ``ln``
(rjenkins1 and crush_ln, in numpy and in torch int64), ``mapper_ref``
(the scalar interpreter) and ``batched`` (``batched_do_rule``: a whole
seed range in one launch of ``csrc/crush_straw2.cu`` on the card).
"""

from .map import CrushMap, Rule  # noqa: F401
from .mapper_ref import crush_do_rule  # noqa: F401
