"""Hand-written CUDA kernels (``csrc/``): one wrapper module per kernel
(:mod:`.quant_matmul`, :mod:`.flash_decode`, :mod:`.flash_attention`),
their plain PyTorch versions (:mod:`.ref`) and the dispatch the models
call (:mod:`.ops`)."""
