"""Trust: secure aggregation, differential privacy, attacks, defenses, the
simulator's trust pipeline and contribution assessment."""
