"""Device-mesh sharding: distributed LM / BA over mesh collectives."""
