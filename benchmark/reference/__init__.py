"""The benchmark's plain reference (:mod:`.step`) and the frozen copy of
the port's plain PyTorch path it runs (:mod:`.plainlio`). Nothing here
imports the program under test, JAX or the JAX package."""
