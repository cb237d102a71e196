"""Exact brute-force 1-NN.

Counterpart of ``nn1`` in ``pcl_tpu/search/bruteforce.py``:
``nn1(target, tmask, queries) -> (index [Q] int32, sqdist [Q] f32)``, index 0
and ``+inf`` where no target is valid, the lowest index winning a tie. The
JAX package sends only large 3-D searches on the TPU to its Pallas kernel and
otherwise returns the matmul-identity distance ``q^2 + t^2 - 2 q.t``; the port
follows the kernel's contract at every size: the CUDA kernel on CUDA tensors
(3-D only, anything else raises) and its plain version on CPU tensors, both
returning the exactly recomputed ``||q - t_idx||^2``. The kNN and radius
searches are ported with the neighbourhood-search slice.
"""

from pcl_tpu_torch.ops.nn1 import nn1

__all__ = ["nn1"]
