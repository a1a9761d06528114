# optpricer_tpu_torch.models — pricing engines (Monte Carlo, CRR lattice).
