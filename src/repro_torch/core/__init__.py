"""Knowledge Bank semantics, engine and coalescing server of the port."""
