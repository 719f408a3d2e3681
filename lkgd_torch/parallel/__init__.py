"""Multi-process inference and training on ``torch.distributed``: the mesh's process groups
(``mesh.py``), sequence-parallel attention and the collectives over them (``sequence.py``),
and weight sharding over the ``model`` axis (``tp.py``)."""
