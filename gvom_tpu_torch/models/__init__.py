from gvom_tpu_torch.models.pipeline import buffer_insert, combine, full_step, ingest_and_insert, ingest_scan

__all__ = ["ingest_scan", "buffer_insert", "combine", "ingest_and_insert", "full_step"]
