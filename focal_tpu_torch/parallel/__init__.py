"""Multi-process training: one process per card (``distributed``), the
(data, model) layout of the processes (``mesh``) and the tensor-parallel
rules (``tp``)."""
