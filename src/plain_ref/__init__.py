"""Plain PyTorch references of models the port serves beyond the JAX
package's architectures: float32 forward passes with no kernel, cache or
batching, written from the published descriptions, importing nothing of
`repro` or `repro_torch`."""
