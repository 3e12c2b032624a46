"""The port's batches as the JAX package's trainer reads them.

The JAX package sends a batch's program tensors to its device as one int32
buffer (``LoadedBatch.packed``, made by its ``pack_arrays`` from the
batch's ``arrays`` and ``meta``); the port sends them one by one and makes
no such buffer. ``JaxLoader`` hands the JAX package a port loader's batches
with that buffer added, so that both packages run the same batches.
"""

from dfol_vqa_tpu.compiler.program_compiler import pack_arrays


class JaxBatch:
    """A port ``LoadedBatch`` with the JAX package's ``packed`` buffer;
    every other attribute is the port batch's."""

    def __init__(self, batch):
        self._batch = batch
        self.packed = pack_arrays(batch.arrays, batch.meta)

    def __getattr__(self, name):
        return getattr(self._batch, name)


class JaxLoader:
    """Iterates ``loader`` (a port loader or a list of its batches) as
    ``JaxBatch``es, afresh on every pass, as the loader does."""

    def __init__(self, loader):
        self._loader = loader

    def __iter__(self):
        return (JaxBatch(b) for b in self._loader)
