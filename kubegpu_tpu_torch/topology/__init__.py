"""Inventory-shape trees for the GPU scheduler's auto-topology mode."""
