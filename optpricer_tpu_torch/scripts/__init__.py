# optpricer_tpu_torch.scripts — end-to-end workflows, each runnable with
# python -m optpricer_tpu_torch.scripts.<name> [--device cpu].
