"""End-to-end models: the obstacle shape optimization (models.obstacle)."""
