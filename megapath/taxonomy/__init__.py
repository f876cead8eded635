from megapath.taxonomy.taxdb import TaxDB, remove_version, get_accession  # noqa: F401
from megapath.taxonomy.report import KrakenReport  # noqa: F401
