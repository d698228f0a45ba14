"""Data parallelism over pixels, tables sharded by slot, and several
processes: the port of the JAX package's ``parallel/``.

``mesh.py`` makes the (data, model) grid of ``torch.distributed`` ranks
and places params and batches on it; ``train_parallel.py`` the parallel
epoch; ``launch.py`` starts ranks as processes. The sums with their
autograd rules are ``ops/collectives.py``, below the model: the model and
the training step get a process group and a ``TableShard`` from here and
import nothing of this package. Nothing is imported here.
"""
