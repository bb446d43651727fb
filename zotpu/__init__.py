"""zotpu: a JAX k-mer workbench for accelerators (capabilities of drtconway/zotmer)."""

__version__ = "0.1.0"
