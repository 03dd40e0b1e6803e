"""Helper scripts (counterpart of the reference's scripts/ directory).

Each module has a ``main(arg_list=None)`` and is exposed via
``python -m poppunk_tpu_torch.scripts.<name>``:

    rand_index          <-> poppunk_calculate_rand_indices.py
    silhouette          <-> poppunk_calculate_silhouette.py
    extract_components  <-> poppunk_extract_components.py
    extract_distances   <-> poppunk_extract_distances.py
    add_weights         <-> poppunk_add_weights.py
    distribute_fit      <-> poppunk_distribute_fit.py
    easy_run            <-> poppunk_easy_run.py
    iterate             <-> poppunk_iterate.py
    batch_mst           <-> poppunk_batch_mst.py
"""
