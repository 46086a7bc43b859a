"""The roofline of a dry run: ``analysis`` (the three terms on the card's
peaks) and ``op_cost`` (one rank's counted ops, ``hlo_cost``'s
counterpart)."""
