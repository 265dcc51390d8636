"""Flash attention: tiled online-softmax attention (causal, sliding window,
softcap, GQA, decode offset)."""
