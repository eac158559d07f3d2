"""Model modules of the port: layers, the three sub-models, the fused
upsampler head and the chain."""
