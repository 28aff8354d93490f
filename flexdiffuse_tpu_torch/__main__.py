"""``python -m flexdiffuse_tpu_torch`` launches the web UI (the JAX
package's ``__main__``)."""
from flexdiffuse_tpu_torch.interface.app import main

main()
