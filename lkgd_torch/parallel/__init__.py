"""Multi-process inference on ``torch.distributed``: the ``context`` process group
(``mesh.py``) and sequence-parallel attention over it (``sequence.py``)."""
