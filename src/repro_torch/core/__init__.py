"""Graph construction, angle profile, routers and the batched search engine."""
