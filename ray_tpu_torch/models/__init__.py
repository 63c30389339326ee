"""Models of the port: `gpt`, `moe`, `vit` and `resnet`, each the
counterpart of the JAX package's module of the same name."""
