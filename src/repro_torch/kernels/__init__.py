"""Hand-written CUDA kernels (``csrc/``): one wrapper module per source
(:mod:`.quant_matmul`, :mod:`.flash_decode` with its dense / int8 / paged /
paged-int8 decode and verify variants, :mod:`.flash_attention`,
:mod:`.quant_error`, :mod:`.rms_norm`; flash_attention and rms_norm also
with their backward kernels), their
plain PyTorch versions (:mod:`.ref`) and the dispatch the models call
(:mod:`.ops`)."""
