# optpricer_tpu_torch.ops — closed forms, sufficient statistics, the
# Threefry generator and f32 fast math, and the Monte-Carlo kernel wrappers.
