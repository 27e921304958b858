"""The MDD (Model Discovery & Distillation) system over the continuum."""
