"""Device-idle ms a request spent in the kernel wrappers
(``optpricer.launch.<kernel>``): input checks, buffer allocation, the
library call that launches; averaged over the window's requests."""
from ._spans import LAUNCH, idle_ms


def read(ctx):
    return idle_ms(ctx, LAUNCH)
