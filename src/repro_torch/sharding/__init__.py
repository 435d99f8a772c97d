"""The mesh layer's rules and collectives (``repro.sharding``
counterparts): ``specs`` (parameter, input and state specs), ``ctx`` (the
activation policy) and ``collectives`` (every collective the port issues,
counted)."""
