"""The system under test: each module binds one public call of
``optpricer_tpu_torch`` to a traffic mix's requests. ``setup(config,
traffic, device)`` does the call's set-up and returns ``call(request) ->
{"price": array, "se": array}`` (host float64; ``se`` absent where the
call gives none). Nothing here computes a price."""
