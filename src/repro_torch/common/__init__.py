"""Parameter specification shared by the port's models."""
