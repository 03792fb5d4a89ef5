"""Scene layer: JSON loader, SoA schema, Perlin tables."""
